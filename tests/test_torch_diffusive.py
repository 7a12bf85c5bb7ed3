"""Port parity for the diffusive-wave solver (``troute_torch/diffusive``)
against the JAX package's (``troute_tpu/diffusive``) and the scalar
reference oracle's inputs, on the same NumPy inputs.  The JAX runs are shared through module-scoped fixtures.

Tolerances:
* NumPy table builders: bit-identical; the torch builder within rtol and
  atol 1e-12 of the NumPy one (cumulative sums in another order), and
  finite at high elevation in f32;
* both predictor forms against JAX's: f64 rtol 1e-10 (the doubling scans
  pair the maps in another order than ``lax.associative_scan``);
* ``initialize_state`` and ``run_diffusive`` against JAX's, both
  correctors, exact and uniform tables, a coastal depth series: f64 rtol
  1e-9 (atol 1e-9 on values near 0);
and ``troute_torch.diffusive.domain.build_domain`` equal to JAX's (the
tables to 1e-9 where both build them on the device).  The oracle, the
dispatch forms and f32 are in ``test_torch_diffusive_oracle.py``, batched
runs in ``test_torch_diffusive_batched.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from troute_tpu.diffusive import domain as jdomain
from troute_tpu.diffusive import solver as jsolver
from troute_tpu.diffusive import xsection as jxs
from troute_torch import convert
from troute_torch.diffusive import domain as tdomain
from troute_torch.diffusive import solver as tsolver
from troute_torch.diffusive import xsection as txs

from test_diffusive_parity import _network_fixture
from test_diffusive_predictor import _random_network, _random_state

torch.set_num_threads(1)

DT = 300.0
CPU = dict(device="cpu", dtype=torch.float64)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x)


def _close(got, want, rtol=1e-9, atol=1e-9, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _both_domains(reaches, ds, qlat, trib, **kw):
    jdom = jdomain.build_domain(reaches, ds, qlat, DT, trib, DT, DT, **kw)
    tdom = tdomain.build_domain(reaches, ds, qlat, DT, trib, DT, DT, **CPU,
                                **kw)
    return jdom, tdom


def _q0(dom, values):
    C = dom.n_cols
    ncomp = _np(dom.ncomp)
    q0 = np.zeros((len(values), C))
    for j, v in enumerate(values):
        q0[j, C - ncomp[j]:] = v
    return q0


# ------------------------------------------------------------- tables

def _geometry(rng, R, C):
    z = rng.uniform(0, 100, (R, C))
    bo = rng.uniform(15, 40, (R, C))
    return (z, bo, rng.uniform(0.5, 2.0, (R, C)),
            bo + rng.uniform(10, 60, (R, C)),
            bo + rng.uniform(110, 360, (R, C)), np.full((R, C), 0.035),
            np.full((R, C), 0.07), rng.uniform(500, 3000, (R, C)))


def test_numpy_table_builders_bit_identical():
    rng = np.random.default_rng(7)
    geo = _geometry(rng, 300, 5)          # past one 256-reach chunk
    t_t, z_t = txs.build_xsec_tables(*geo)
    t_j, z_j = jxs.build_xsec_tables(*geo)
    np.testing.assert_array_equal(t_t, t_j)
    np.testing.assert_array_equal(z_t, z_j)
    xb = np.array([0.0, 5.0, 12.0, 20.0, 31.0, 40.0])
    zb = np.array([9.0, 4.0, 1.5, 1.0, 3.5, 8.0])
    nb = np.array([0.06, 0.04, 0.035, 0.035, 0.05, 0.08])
    for a, b in zip(txs.build_xsec_table_natural(xb, zb, nb),
                    jxs.build_xsec_table_natural(xb, zb, nb)):
        np.testing.assert_array_equal(a, b)
    v = np.array([1.0, 2.0, 1.5, 1.2, 3.0, 2.9, 4.0])
    el = np.arange(7.0)
    np.testing.assert_array_equal(txs._monotone_smooth(el, v),
                                  jxs._monotone_smooth(el, v))


def test_torch_table_builder_matches_numpy():
    geo = _geometry(np.random.default_rng(7), 24, 6)
    t_np, z_np = txs.build_xsec_tables(*geo)
    t_t, z_t = txs.build_xsec_tables_torch(*geo, **CPU)
    np.testing.assert_allclose(t_t.numpy(), t_np, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(z_t, z_np)


def test_torch_tables_finite_at_high_elevation_f32():
    Z = np.linspace(130.0, 140.0, 16)[None].repeat(4, 0)
    ones = np.ones((4, 16))
    tab, _ = txs.build_xsec_tables_torch(
        Z, 20 * ones, ones, 60 * ones, 180 * ones, 0.035 * ones,
        0.07 * ones, 1500 * ones, device="cpu", dtype=torch.float32)
    assert tab.dtype == torch.float32 and bool(torch.isfinite(tab).all())


def test_build_domain_matches_jax():
    """Every field of the port's domain equals JAX's, the device-table
    path (2,048 nodes or more) included."""
    for args in (_network_fixture(), tuple(_mainstem(128, 16))):
        reaches, ds, qlat, trib = args[0], args[1], args[2], args[3]
        jdom, tdom = _both_domains(reaches, ds, qlat, trib, nel_uniform=64)
        for f in tsolver.DiffusiveDomain._fields:
            a, b = getattr(tdom, f), getattr(jdom, f)
            # the device builders sum the first moment (column 6) in
            # different orders: the JAX test of its two builders holds
            # them to 1e-9 (tests/test_diffusive.py:212-235), and the
            # resampled tables carry that on
            tol = (1e-9 if f in ("xsec", "xsec_min", "utab", "utab_min")
                   else 1e-12)
            if isinstance(a, torch.Tensor):
                _close(a, b, rtol=tol, atol=tol, what=f)
            else:
                assert a == b, f


def _mainstem(R, C):
    from troute_torch.synthetic import mainstem_tree
    reaches, ds, qlat, _, trib, _, _ = mainstem_tree(R, C)
    return reaches, ds, qlat, trib


# ---------------------------------------------------------- predictor

@pytest.mark.parametrize("n_reaches,max_nodes,seed",
                         [(1, 9, 0), (7, 16, 1), (40, 13, 2)])
def test_predictor_forms_match_jax(n_reaches, max_nodes, seed):
    rng = np.random.default_rng(seed)
    reaches, ds, qlat, trib, dt = _random_network(rng, n_reaches, max_nodes)
    jdom = jdomain.build_domain(reaches, ds, qlat, dt, trib, dt, dt)
    jst = _random_state(rng, jdom, jnp.float64)
    tdom = convert.from_diffusive_domain(jdom, **CPU)
    tst = convert.from_diffusive_state(jst, **CPU)
    dtini = 123.0
    valid = _np(jdom.valid)
    want = jsolver.predictor_seq(jdom, jst, jnp.asarray(dtini), jst.t)
    for form in ("seq", "assoc"):
        got = tsolver.predictor(tdom, tst, torch.tensor(dtini,
                                                        dtype=torch.float64),
                                tst.t, form=form)
        for g, w in zip(got, want):
            _close(_np(g)[valid], _np(w)[valid], rtol=1e-10, atol=1e-12,
                   what=form)


# -------------------------------------------- runs against the JAX solver

CASES = {
    "wavefront_exact": dict(mode="wavefront"),
    "jacobi_exact": dict(mode="jacobi"),
    "jacobi_uniform": dict(mode="jacobi", nel_uniform=128),
    "wavefront_coastal": dict(mode="wavefront", coastal=True),
    "jacobi_coastal": dict(mode="jacobi", coastal=True),
}


def _case_inputs(coastal):
    reaches, ds, qlat, trib, dt = _network_fixture(nts=24)
    kw = {}
    if coastal:
        hours = np.arange(5)
        kw = dict(db_depth=np.stack([np.full(5, np.nan), np.full(5, np.nan),
                                     2.5 + 0.8 * np.sin(hours / 2.0)]),
                  dt_db=3600.0)
    return reaches, ds, qlat, trib, kw


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's initialize_state and run_diffusive (host dispatch) per case."""
    out = {}
    for name, c in CASES.items():
        reaches, ds, qlat, trib, kw = _case_inputs(c.get("coastal", False))
        if c.get("nel_uniform"):
            kw["nel_uniform"] = c["nel_uniform"]
        jdom = jdomain.build_domain(reaches, ds, qlat, DT, trib, DT, DT, **kw)
        q0 = jnp.asarray(_q0(jdom, [60.0, 40.0, 100.0]))
        st0 = jsolver.initialize_state(jdom, q0, DT / 10.0,
                                       corrector_mode=c["mode"])
        st, saves = jsolver.run_diffusive(jdom, st0, 2 * 3600.0, DT,
                                          corrector_mode=c["mode"],
                                          dispatch="host")
        out[name] = (reaches, ds, qlat, trib, kw, st0, st, saves)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_initialize_and_run_match_jax(jax_runs, name):
    c = CASES[name]
    reaches, ds, qlat, trib, kw, jst0, jst, jsaves = jax_runs[name]
    tdom = tdomain.build_domain(reaches, ds, qlat, DT, trib, DT, DT, **CPU,
                                **kw)
    valid = _np(tdom.valid)
    st0 = tsolver.initialize_state(tdom, torch.as_tensor(_q0(
        tdom, [60.0, 40.0, 100.0])), DT / 10.0, corrector_mode=c["mode"])
    for f in ("q", "y", "celerity", "diffusivity"):
        _close(_np(getattr(st0, f))[valid], _np(getattr(jst0, f))[valid],
               what=f"init {f}")
    stats = {}
    st, saves = tsolver.run_diffusive(tdom, st0, 2 * 3600.0, DT,
                                      corrector_mode=c["mode"],
                                      dispatch="host", stats=stats)
    assert len(saves) == len(jsaves) == 24
    for (t1, q1, y1), (t2, q2, y2) in zip(saves, jsaves):
        assert t1 == pytest.approx(t2, abs=1e-9)
        _close(_np(q1)[valid], _np(q2)[valid], what=f"q at {t1}")
        _close(_np(y1)[valid], _np(y2)[valid], what=f"y at {t1}")
    for f in ("q", "y", "qpx", "celerity", "diffusivity", "t"):
        _close(_np(getattr(st, f))[valid] if f != "t" else _np(st.t),
               _np(getattr(jst, f))[valid] if f != "t" else _np(jst.t),
               what=f)
    assert stats["substeps"] >= 24 and stats["rtsafe_calls"] > 0
    assert stats["syncs"] >= stats["substeps"]
    if c["mode"] == "jacobi":
        assert len(stats["sweeps"]) == stats["substeps"]

"""The coastal downstream boundary (dsbc_option == 1) in the port against
the JAX package: the three in-memory cases of ``tests/test_coastal.py``
(each keeps its own assertions and is held to the JAX run on the same
inputs at rtol 1e-9, atol 1e-9, float64), and the SCHISM readers of
``troute_torch/io/coastal.py`` against ``troute_tpu/io/coastal.py`` on a
SCHISM-shaped file written with h5py (exactly equal)."""

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

import jax.numpy as jnp

from test_coastal import _prism_reach
from troute_torch.diffusive import domain as tdomain
from troute_torch.diffusive import solver as tsolver
from troute_torch.io import coastal as tcoastal
from troute_tpu.diffusive import domain as jdomain
from troute_tpu.diffusive import solver as jsolver
from troute_tpu.io import coastal as jcoastal

torch.set_num_threads(1)

DT = 300.0


def _run(pkg, reach, qlat, trib, q_in, t_final, **kw):
    """(domain, initial state, final state) of one package's run."""
    if pkg == "jax":
        dom = jdomain.build_domain([reach], [-1], qlat, DT, trib, DT, DT,
                                   **kw)
        q0 = jnp.full((1, dom.n_cols), q_in, jnp.float64)
        st0 = jsolver.initialize_state(dom, q0, dtini_min=DT / 10.0)
        st = (jsolver.run_diffusive(dom, st0, t_final=t_final,
                                    save_interval=DT, dispatch="host")[0]
              if t_final else st0)
        return dom, st0, st
    dom = tdomain.build_domain([reach], [-1], qlat, DT, trib, DT, DT,
                               device="cpu", dtype=torch.float64, **kw)
    q0 = torch.full((1, dom.n_cols), q_in, dtype=torch.float64)
    st0 = tsolver.initialize_state(dom, q0, dtini_min=DT / 10.0)
    st = (tsolver.run_diffusive(dom, st0, t_final=t_final,
                                save_interval=DT)[0] if t_final else st0)
    return dom, st0, st


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(reach, qlat, trib, q_in, t_final, **kw):
    t = _run("torch", reach, qlat, trib, q_in, t_final, **kw)
    j = _run("jax", reach, qlat, trib, q_in, t_final, **kw)
    for a, b in zip(t[1:], j[1:]):
        for f in ("q", "y", "celerity", "diffusivity"):
            np.testing.assert_allclose(_np(getattr(a, f)),
                                       _np(getattr(b, f)), rtol=1e-9,
                                       atol=1e-9, err_msg=f)
    return t


def test_coastal_boundary_pins_tailwater_elevation():
    """A surge ramp at the tailwater: its depth follows the series, and
    the interior backs up over the normal-depth run."""
    nts, q_in = 48, 150.0
    r = _prism_reach()
    n = len(r["z"])
    qlat = np.zeros((nts, 1, n))
    trib = np.full((nts, 1), q_in)
    dom2, _, st2 = _both(r, qlat, trib, q_in, 4 * 3600.0)
    d_norm = float(st2.y[0, -1] - dom2.z[0, -1])
    surge = d_norm + np.linspace(0.0, 3.0, 9)
    dom1, _, st1 = _both(r, qlat, trib, q_in, 4 * 3600.0,
                         db_depth=surge[None, :], dt_db=1800.0)
    d_tw = float(st1.y[0, -1] - dom1.z[0, -1])
    assert abs(d_tw - surge[-1]) < 0.05
    assert float(st1.y[0, -2]) > float(st2.y[0, -2]) + 1.0
    assert torch.isfinite(st1.q).all()


def test_coastal_nan_row_falls_back_to_normal_depth():
    nts, q_in = 24, 150.0
    r = _prism_reach()
    n = len(r["z"])
    qlat = np.zeros((nts, 1, n))
    trib = np.full((nts, 1), q_in)
    _, _, st1 = _both(r, qlat, trib, q_in, 3600.0,
                      db_depth=np.full((1, 6), np.nan), dt_db=1800.0)
    _, _, st2 = _both(r, qlat, trib, q_in, 3600.0)
    np.testing.assert_allclose(st1.y.numpy(), st2.y.numpy(), rtol=0,
                               atol=1e-12)


def test_min_depth_clamp():
    """Prescribed depth below the stability floor is clamped to 0.1 m
    (diffusive.f90:264, mindepth_nstab)."""
    nts, q_in = 24, 20.0
    r = _prism_reach()
    n = len(r["z"])
    qlat = np.zeros((nts, 1, n))
    trib = np.full((nts, 1), q_in)
    dom, st, _ = _both(r, qlat, trib, q_in, 0.0,
                       db_depth=np.full((1, 6), 0.01), dt_db=1800.0)
    assert abs(float(st.y[0, -1] - dom.z[0, -1]) - 0.1) < 1e-9


def test_schism_readers_match_jax(tmp_path):
    """A SCHISM ``schout`` file (elev [time, node], bathymetric depth,
    seconds since a base date) and a crosswalk YAML, read by both."""
    rng = np.random.default_rng(4)
    n_t, n_nodes = 30, 5
    p = tmp_path / "schout_1.nc"
    with h5py.File(p, "w") as f:
        f["time"] = np.arange(1, n_t + 1) * 3600.0
        f["time"].attrs["units"] = "seconds since 2020-08-26 00:00:00+00:00"
        f["elev"] = rng.uniform(-0.5, 2.0, (n_t, n_nodes))
        f["depth"] = rng.uniform(2.0, 6.0, n_nodes)
    dom_p = tmp_path / "coastal_boundary_domain.yaml"
    dom_p.write_text(yaml.safe_dump({5781901: 3, 5781905: 0}))
    xwalk = tmp_path / "nexus_crosswalk.yaml"
    xwalk.write_text(yaml.safe_dump({"coastal_hy_crosswalk": {7: 1}}))
    for path in (dom_p, xwalk):
        got = tcoastal.read_coastal_boundary_domain(path)
        assert got == jcoastal.read_coastal_boundary_domain(path)
    domain = tcoastal.read_coastal_boundary_domain(dom_p)
    assert domain == {5781901: 3, 5781905: 0}
    base, dt_sec, series = tcoastal.read_coastal_depth_series(p, domain)
    jbase, jdt, jseries = jcoastal.read_coastal_depth_series(p, domain)
    assert base == jbase == pd.Timestamp("2020-08-26")
    assert dt_sec == jdt == 3600.0
    assert series.keys() == jseries.keys()
    for k in series:
        np.testing.assert_array_equal(series[k], jseries[k])
        assert series[k].size == n_t + 1
        np.testing.assert_allclose(series[k][0],
                                   2 * series[k][1] - series[k][2])
    args = (p, dom_p, pd.Timestamp("2020-08-26 13:00"), [5781901], 3,
            {5781901: 1})
    db, dt_db = tcoastal.coastal_db_for_domain(*args)
    jdb, jdt_db = jcoastal.coastal_db_for_domain(*args)
    np.testing.assert_array_equal(db, jdb)
    assert dt_db == jdt_db == 3600.0
    assert db.shape[0] == 3 and np.isnan(db[0]).all()
    np.testing.assert_allclose(db[1, 0], series[5781901][13])
    assert tcoastal.coastal_db_for_domain(
        p, dom_p, pd.Timestamp("2020-08-26"), [1], 2, {1: 0}) == \
        (None, None)


def test_schism_reader_needs_h5py_at_the_call(tmp_path, monkeypatch):
    """On a machine without h5py the reader fails at the call with
    an ImportError that names it."""
    import sys
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        tcoastal.read_coastal_depth_series(tmp_path / "x.nc", {1: 0})

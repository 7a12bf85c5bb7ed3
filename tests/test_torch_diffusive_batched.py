"""Batched diffusive runs of the port (``run_diffusive_batched``,
``initialize_state_batched``, ``stack_domains``, ``stack_states``): each
domain of a batch equals that domain routed alone, and the batch equals
the JAX package's batched run on the same domains.

Tolerances: batched against solo rtol 1e-12
(``tests/test_diffusive_batched.py:95-108``'s bar); against JAX's batched
run f64 rtol 1e-9, atol 1e-9; stacked domains and states equal JAX's
(the tables to 1e-12).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from troute_tpu.diffusive import domain as jdomain
from troute_tpu.diffusive import solver as jsolver
from troute_torch import convert
from troute_torch.diffusive import domain as tdomain
from troute_torch.diffusive import solver as tsolver

from test_diffusive_batched import _domains

torch.set_num_threads(1)

DT, NTS = 300.0, 24
CPU = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def jax_batch():
    """The JAX domains, their initial states per corrector and JAX's
    batched runs."""
    doms = _domains(NTS, DT)
    out = {"doms": doms}
    for mode in ("wavefront", "jacobi"):
        sts = [jsolver.initialize_state(
            d, jnp.full((d.n_reaches, d.n_cols), 80.0, jnp.float64),
            dtini_min=DT / 10.0, corrector_mode=mode) for d in doms]
        bdom = jdomain.stack_domains(doms)
        B, R, C = bdom.z.shape
        bst = jdomain.stack_states(sts, doms, C, R)
        out[mode] = (sts, bdom, bst, *jsolver.run_diffusive_batched(
            bdom, bst, NTS * DT, DT, corrector_mode=mode))
    return out


def _port_doms(jdoms):
    return [convert.from_diffusive_domain(d, **CPU) for d in jdoms]


def test_stack_matches_jax(jax_batch):
    doms = _port_doms(jax_batch["doms"])
    sts_j, bdom_j, bst_j = jax_batch["jacobi"][:3]
    bdom = tdomain.stack_domains(doms)
    for f in tsolver.DiffusiveDomain._fields:
        a, b = getattr(bdom, f), getattr(bdom_j, f)
        if isinstance(a, torch.Tensor):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12, err_msg=f)
        else:
            assert a == b, f
    B, R, C = bdom.z.shape
    bst = tdomain.stack_states([convert.from_diffusive_state(s, **CPU)
                                for s in sts_j], doms, C, R)
    for f in tsolver.DiffusiveState._fields:
        np.testing.assert_array_equal(getattr(bst, f).numpy(),
                                      np.asarray(getattr(bst_j, f)), f)


@pytest.mark.parametrize("mode", ["wavefront", "jacobi"])
def test_batched_matches_solo_and_jax(jax_batch, mode):
    doms = _port_doms(jax_batch["doms"])
    _, bdom_j, bst_j, bfin_j, bsaves_j = jax_batch[mode]
    sts = [tsolver.initialize_state(
        d, torch.full((d.n_reaches, d.n_cols), 80.0, dtype=torch.float64),
        DT / 10.0, corrector_mode=mode) for d in doms]
    bdom = tdomain.stack_domains(doms)
    B, R, C = bdom.z.shape
    # the batched initialization equals the solo ones
    bst = tdomain.stack_states(sts, doms, C, R)
    q0 = torch.full((B, R, C), 80.0, dtype=torch.float64)
    bst_init = tsolver.initialize_state_batched(bdom, q0, DT / 10.0,
                                                corrector_mode=mode)
    valid = bdom.valid.numpy()
    for f in ("y", "celerity", "diffusivity"):
        np.testing.assert_allclose(getattr(bst_init, f).numpy()[valid],
                                   getattr(bst, f).numpy()[valid],
                                   rtol=1e-12, err_msg=f)
    stats = {}
    bfin, bsaves = tsolver.run_diffusive_batched(
        bdom, bst, NTS * DT, DT, corrector_mode=mode, stats=stats)
    assert len(bsaves) == len(bsaves_j) == NTS
    assert stats["substeps"] > NTS
    for b, d in enumerate(doms):
        fin, saves = tsolver.run_diffusive(d, sts[b], NTS * DT, DT,
                                           corrector_mode=mode,
                                           dispatch="device")
        dR, dC = d.n_reaches, d.n_cols
        v = d.valid.numpy()
        for f in ("q", "y", "celerity", "diffusivity"):
            a = getattr(bfin, f).numpy()[b, :dR, C - dC:]
            np.testing.assert_allclose(a[v], getattr(fin, f).numpy()[v],
                                       rtol=1e-12, atol=0,
                                       err_msg=f"{f} lane {b}")
        assert float(bfin.t[b]) == pytest.approx(float(fin.t), abs=1e-6)
        for k in range(NTS):
            for i in (1, 2):
                np.testing.assert_allclose(
                    bsaves[k][i].numpy()[b, :dR, C - dC:][v],
                    saves[k][i].numpy()[v], rtol=1e-12,
                    err_msg=f"save {k} field {i} lane {b}")
    for k in range(NTS):
        assert bsaves[k][0] == pytest.approx(bsaves_j[k][0])
        for i in (1, 2):
            np.testing.assert_allclose(bsaves[k][i].numpy()[valid],
                                       np.asarray(bsaves_j[k][i])[valid],
                                       rtol=1e-9, atol=1e-9)
    for f in ("q", "y", "celerity", "diffusivity"):
        np.testing.assert_allclose(getattr(bfin, f).numpy()[valid],
                                   np.asarray(getattr(bfin_j, f))[valid],
                                   rtol=1e-9, atol=1e-9, err_msg=f)


def test_extend_series_preserves_values():
    rng = np.random.default_rng(3)
    s = torch.as_tensor(rng.uniform(1.0, 5.0, (5, 2)))
    e = tdomain._extend_series(s, 9)
    assert e.shape == (9, 2)
    for t in [0.0, 0.4, 1.9, 3.999, 4.0, 5.5, 7.2]:
        tt = torch.tensor(t, dtype=torch.float64)
        np.testing.assert_allclose(tsolver._interp_series(e, 1.0, tt),
                                   tsolver._interp_series(s, 1.0, tt),
                                   rtol=1e-12)

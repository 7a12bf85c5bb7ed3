"""Port parity: the PyTorch MC solve (``troute_torch/ops/muskingum.py``)
and its kernel wrapper (``ops/muskingum_cuda.py``, plain path on the CPU)
against the JAX ``muskingum_cunge``, the JAX Pallas kernel in interpret
mode, and the scalar oracle.

Tolerances.  f64: every lane within rtol 1e-9, atol 1e-12 of JAX (the
reference's own per-lane bar, ``test_muskingum.py:106-110``), except
lanes whose secant residual is ill-conditioned (large cancellation in
Q_MC - Q_manning at flows of 1e4-7e4 m3/s): there a last-ulp difference
between libm ``pow`` implementations grows to ~1e-6, and JAX itself is
that far from the scalar oracle (measured: 5 of the 4096 lanes below).
On those lanes the oracle decides and the port must be at least as close
to it as JAX is.  f32: the reference's bar (``test_muskingum.py:140-142``)
holds against the f32 oracle; against JAX the median and p95 hold at
1e-6 and 1e-5, but a per-lane max cannot: on this extreme distribution
the JAX f32 result is itself up to 9.5x off the f64 solution on single
lanes (secant path flips), so lanes past 5e-2 are bounded as a share.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from troute_tpu.ops.muskingum import muskingum_cunge as jax_mc
from troute_tpu.ops.muskingum_pallas import muskingum_cunge_pallas
from troute_torch.ops import muskingum_cuda
from troute_torch.ops.muskingum import muskingum_cunge, solve_block

from reference_impl import muskingum_cunge_ref
from test_muskingum import (GOLDEN, GOLDEN64_IN, GOLDEN_F32, GOLDEN_F64,
                            _random_params)

torch.set_num_threads(1)

NAMES = ("qup", "quc", "qdp", "ql", "dx", "bw", "tw", "twcc", "n", "ncc",
         "cs", "s0", "depthp")
DT = 300.0
N_LANES = 4096
DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32,
                                                     torch.float32)}


def _inputs(np_dtype, size=N_LANES, seed=0):
    p = _random_params(np.random.default_rng(seed), size)
    return [np.asarray(p[k], np_dtype) for k in NAMES]


def _port(arrs, torch_dtype, **kw):
    out = muskingum_cunge(*[torch.as_tensor(a, dtype=torch_dtype)
                            for a in arrs], DT, **kw)
    return [o.numpy() for o in out]


def _jax(arrs, np_dtype, pallas=False, **kw):
    args = [jnp.asarray(a, np_dtype) for a in arrs]
    if pallas:
        out = muskingum_cunge_pallas(*args, DT)
    else:
        out = jax_mc(*args, jnp.asarray(DT, np_dtype), **kw)
    return [np.asarray(o) for o in out]


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-6)


def assert_f64_parity(port, ref, arrs):
    """Per-lane 1e-9 against ``ref`` (JAX), the scalar oracle deciding on
    the ill-conditioned lanes (see the module docstring)."""
    off = np.zeros(port[0].shape, bool)
    for p, r in zip(port, ref):
        off |= ~np.isclose(p, r, rtol=1e-9, atol=1e-12)
    lanes = np.flatnonzero(off)
    assert lanes.size <= max(1, port[0].size // 200), lanes
    for i in lanes:
        oracle = muskingum_cunge_ref(DT, *[a[i] for a in arrs],
                                     dtype=np.float64)
        for k, (p, r) in enumerate(zip(port, ref)):
            slack = 1e-9 * abs(oracle[k]) + 1e-12
            assert abs(p[i] - oracle[k]) <= max(abs(r[i] - oracle[k]),
                                                slack), (i, k)


def assert_f32_parity(port, ref):
    for k, (p, r) in enumerate(zip(port, ref)):
        rel = _rel(p, r)
        assert np.median(rel) <= 1e-6, k
        assert np.percentile(rel, 95) <= 1e-5, k
        assert (rel > 5e-2).mean() <= 0.005, k


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("path", ["plain", "wrapper"])
def test_golden(dtype, path):
    """The published golden values (test_muskingum.py:19-29)."""
    np_dtype, torch_dtype = DTYPES[dtype]
    inp, want, rel = ((GOLDEN, GOLDEN_F32, 2e-5) if dtype == "f32"
                      else (GOLDEN64_IN, GOLDEN_F64, 1e-7))
    args = [torch.tensor([inp[k]], dtype=torch_dtype) for k in NAMES]
    if path == "plain":
        out = muskingum_cunge(*args, inp["dt"])
    else:
        out = muskingum_cuda.muskingum_cunge_cuda(*args, inp["dt"])
    for got, exp in zip(out[:3], want):
        assert float(got[0]) == pytest.approx(exp, rel=rel)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
def test_vs_jax(dtype, jax_path):
    """4096 lanes of the CONUS parameter ranges, all six outputs."""
    np_dtype, torch_dtype = DTYPES[dtype]
    arrs = _inputs(np_dtype)
    port = _port(arrs, torch_dtype)
    ref = _jax(arrs, np_dtype, pallas=jax_path == "pallas")
    if dtype == "f64":
        assert_f64_parity(port, ref, arrs)
    else:
        assert_f32_parity(port, ref)


def test_f32_reference_bar_vs_oracle():
    """The reference's own f32 bar against the f32 scalar oracle, on the
    lanes of ``test_muskingum.test_vs_oracle_random_f32``."""
    size = 128
    p = _random_params(np.random.default_rng(7), size)
    arrs = [np.asarray(p[k], np.float32) for k in NAMES]
    qdc = _port(arrs, torch.float32)[0]
    rel = np.zeros(size)
    for i in range(size):
        ref = muskingum_cunge_ref(DT, *[a[i] for a in arrs],
                                  dtype=np.float32)
        rel[i] = abs(qdc[i] - ref[0]) / max(abs(ref[0]), 1e-6)
    assert np.median(rel) == 0.0
    assert np.percentile(rel, 95) < 1e-5
    assert rel.max() < 5e-2


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_no_flow_exact_zero(dtype):
    _, torch_dtype = DTYPES[dtype]
    z = torch.zeros(4, dtype=torch_dtype)
    one = torch.ones(4, dtype=torch_dtype)
    out = muskingum_cuda.muskingum_cunge_cuda(
        z, z, z, z, 1800.0 * one, 112.0 * one, 448.0 * one, 623.6 * one,
        0.028 * one, 0.031 * one, 1.4 * one, 0.0018 * one, z, DT)
    for o in (out.qdc, out.velc, out.depthc, out.X):
        assert torch.equal(o, torch.zeros_like(o))


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_lane_result_independent_of_batch_length(dtype):
    """Each lane's outputs are the same, bit for bit, whatever the length
    of the batch it is solved in: the first 1, 5, 37 and 1000 lanes alone
    against all 4096 together, as B1's are.  ``route_stepped`` solves
    batches of the network's own length, and the sharded drivers of the
    partition's padded length."""
    np_dtype, torch_dtype = DTYPES[dtype]
    arrs = _inputs(np_dtype)
    full = _port(arrs, torch_dtype)
    for n in (1, 5, 37, 1000):
        for p, f in zip(_port([a[:n] for a in arrs], torch_dtype), full):
            np.testing.assert_array_equal(p, f[:n], err_msg=str(n))


@pytest.mark.parametrize("max_trips", [1, 3, 12])
def test_max_trips_matches_jax(max_trips):
    arrs = _inputs(np.float64, size=512, seed=5)
    port = _port(arrs, torch.float64, max_trips=max_trips)
    ref = _jax(arrs, np.float64, max_trips=max_trips)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(p, r, rtol=1e-9, atol=1e-12)


def test_wrapper_cpu_runs_plain_version_without_launch():
    arrs = [torch.as_tensor(a) for a in _inputs(np.float64, size=256)]
    before = muskingum_cuda.LAUNCHES
    full = muskingum_cuda.muskingum_cunge_cuda(*arrs, DT)
    lean = muskingum_cuda.muskingum_cunge_cuda(*arrs, DT,
                                               with_diagnostics=False)
    assert muskingum_cuda.LAUNCHES == before == 0
    plain = solve_block(*arrs, dt=DT)
    for got, want in zip(full, plain):
        assert torch.equal(got, want)
    for got, want in zip(lean[:3], plain[:3]):
        assert torch.equal(got, want)
    for o in lean[3:]:
        assert torch.equal(o, torch.zeros_like(o))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    arrs = [torch.as_tensor(a) for a in _inputs(np.float64, size=8)]
    call = muskingum_cuda.muskingum_cunge_cuda
    with pytest.raises(ValueError):
        call(arrs[0][:4], *arrs[1:], DT)
    with pytest.raises(ValueError):
        call(arrs[0].float(), *arrs[1:], DT)
    with pytest.raises(TypeError):
        call(*[a.half() for a in arrs], DT)
    with pytest.raises(ValueError):
        strided = torch.stack([arrs[0], arrs[0]], dim=1)[:, 0]
        call(strided, *arrs[1:], DT)
    # the block-skip form needs both its flags and the previous outputs
    with pytest.raises(ValueError, match="together"):
        call(*arrs, DT, active_rows=torch.ones(8, dtype=torch.bool))

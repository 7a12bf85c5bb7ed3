"""Per-lane secant trip and evaluation counts of the plain MC solve
(``solve_block(..., return_trips=True)``), which kernel B1 reports the
same way (``muskingum_cunge_cuda(..., return_trips=True)``; the card
tests hold the two equal).  A lane's trips are the passes of the secant
loop in which it was still active, its evaluations those of them that
passed the top check and evaluated the residual; both depend on the lane
alone.  All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from chip_smoke import conus_range_inputs
from troute_torch.ops import muskingum_cuda
from troute_torch.ops.muskingum import solve_block

DT = 300.0


def _inputs(n, dtype, seed=0):
    return [torch.as_tensor(a, dtype=dtype)
            for a in conus_range_inputs(n, seed=seed)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_trips_leave_results_unchanged(dtype):
    args = _inputs(2048, dtype)
    plain = solve_block(*args, dt=DT)
    with_trips = solve_block(*args, dt=DT, return_trips=True)
    assert len(plain) == 6 and len(with_trips) == 8
    for a, b in zip(plain, with_trips):
        assert torch.equal(a, b)
    trips, evals = with_trips[6:]
    for c in (trips, evals):
        assert c.dtype == torch.int32 and c.shape == args[0].shape
    assert int(evals.min()) >= 1   # every lane of these ranges has flow
    assert bool((evals <= trips).all()) and bool((evals < trips).any())


def test_trips_of_a_lane_alone_equal_its_trips_in_a_batch():
    args = _inputs(2048, torch.float32, seed=4)
    trips, evals = solve_block(*args, dt=DT, return_trips=True)[6:]
    lanes = [int(trips.argmax()), int(trips.argmin()), 0, 777, 2047]
    for i in lanes:
        alone = solve_block(*[a[i:i + 1] for a in args], dt=DT,
                            return_trips=True)[6:]
        assert int(alone[0][0]) == int(trips[i]), i
        assert int(alone[1][0]) == int(evals[i]), i


def test_no_flow_lanes_take_no_trips():
    args = _inputs(256, torch.float64)
    flow = torch.arange(256) % 3 == 0
    for k in range(4):   # qup, quc, qdp, ql
        args[k] = torch.where(flow, args[k], 0.0)
    out = solve_block(*args, dt=DT, return_trips=True)
    assert torch.equal(out[6] == 0, ~flow) and torch.equal(out[7] == 0, ~flow)
    for o in (out[0], out[1], out[2], out[5]):
        assert not bool(o[~flow].any())


def test_max_trips_equals_the_loop_trip_count():
    args = _inputs(4096, torch.float32, seed=2)
    full = solve_block(*args, dt=DT, return_trips=True)
    m = int(full[6].max())
    assert m > 100   # a lane that retried
    capped = solve_block(*args, dt=DT, max_trips=m, return_trips=True)
    for a, b in zip(full, capped):
        assert torch.equal(a, b)
    short = solve_block(*args, dt=DT, max_trips=m - 1, return_trips=True)[6]
    assert int(short.max()) == m - 1
    assert torch.equal(short, torch.clamp_max(full[6], m - 1))


def test_wrapper_returns_trips_on_cpu():
    args = _inputs(1000, torch.float32, seed=5)
    out, trips, evals = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, return_trips=True)
    want = solve_block(*args, dt=DT, return_trips=True)
    assert torch.equal(trips, want[6]) and torch.equal(evals, want[7])
    for a, b in zip(out, want[:6]):
        assert torch.equal(a, b)
    out3, trips3, evals3 = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, with_diagnostics=False, return_trips=True)
    assert torch.equal(trips3, want[6]) and torch.equal(evals3, want[7])
    assert not bool(out3.X.any())
    # the block-skip form reports the same counts on the lanes it solves
    # and 0 on the lanes it passes through
    active = torch.zeros(1000, dtype=torch.bool)
    active[300] = True
    ran = muskingum_cuda.block_active_lanes(active)
    assert 0 < int(ran.sum()) < 1000
    _, trips_s, evals_s = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, active_rows=active, prev=out, return_trips=True)
    assert torch.equal(trips_s, torch.where(ran, want[6], 0))
    assert torch.equal(evals_s, torch.where(ran, want[7], 0))
    np.testing.assert_array_equal(
        muskingum_cuda.muskingum_cunge_cuda(*args, DT).qdc.numpy(),
        want[0].numpy())

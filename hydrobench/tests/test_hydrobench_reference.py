"""The frozen plain reference: its vector secant against its own
one-lane oracle, its compaction against none, and the frozen copies
against the program's plain versions as they stand."""

import numpy as np
import pytest
import torch

from hydrobench.reference import levelpool, mc, mc_levelpool


def lanes(n, seed, dtype=torch.float64):
    """CONUS-range Muskingum-Cunge inputs, with no-flow lanes, cold and
    deep starts and overbank depths among them."""
    rng = np.random.default_rng(seed)
    a = dict(qup=rng.uniform(0, 300, n), quc=rng.uniform(0, 300, n),
             qdp=rng.uniform(0, 300, n), ql=rng.uniform(0, 40, n),
             dx=rng.uniform(500, 3000, n), bw=rng.uniform(2, 20, n),
             tw=rng.uniform(25, 60, n), twcc=rng.uniform(80, 200, n),
             n=np.full(n, 0.055), ncc=np.full(n, 0.11),
             cs=rng.uniform(0.3, 1.5, n), s0=rng.uniform(0.001, 0.02, n),
             depthp=rng.uniform(0.0, 8.0, n))
    for k in ("qup", "quc", "qdp", "ql"):
        a[k][:20] = 0.0                    # no flow at all
    a["bw"][20:30] = a["tw"][20:30] + 1.0   # bw > tw
    a["bw"][30:40] = a["tw"][30:40]         # bw == tw
    a["twcc"][40:50] = 0.0                  # no floodplain
    return {k: torch.as_tensor(v, dtype=dtype) for k, v in a.items()}


ORDER = ("qup", "quc", "qdp", "ql", "dx", "bw", "tw", "twcc", "n", "ncc",
         "cs", "s0", "depthp")


def test_vector_solver_matches_its_one_lane_oracle():
    a = lanes(400, 1)
    qdc, velc, depthc, evals = mc.solve(*[a[k] for k in ORDER], dt=300.0)
    for i in range(400):
        want = mc.solve_lane(*[float(a[k][i]) for k in ORDER], dt=300.0)
        got = (float(qdc[i]), float(velc[i]), float(depthc[i]))
        np.testing.assert_allclose(got, want[:3], rtol=1e-9, atol=1e-12,
                                   err_msg=f"lane {i}")
        assert int(evals[i]) == want[3], f"lane {i}"
    assert int(evals[:20].sum()) == 0 and int(evals[20:].min()) >= 1


def _same(got, want, exact: bool):
    """Exact on the card; on the CPU a lane's last bits depend on where it
    lies in the batch (vectorized and scalar loops round ``pow``
    differently), so there float32 values agree to a few ulps."""
    for g, w in zip(got, want):
        if exact or g.dtype == torch.int32:
            assert torch.equal(g, w)
        else:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


def _compaction(device):
    a = {k: v.to(device) for k, v in lanes(3000, 2, torch.float32).items()}
    got = mc.solve(*[a[k] for k in ORDER], dt=300.0)
    saved = mc.COMPACT_BELOW
    mc.COMPACT_BELOW = 0.0
    try:
        want = mc.solve(*[a[k] for k in ORDER], dt=300.0)
    finally:
        mc.COMPACT_BELOW = saved
    _same(got, want, device != "cpu")


def _frozen_vs_program(device):
    from troute_torch.ops import muskingum
    from troute_torch.ops.levelpool import LevelpoolParams, levelpool_step
    a = {k: v.to(device) for k, v in lanes(3000, 3, torch.float32).items()}
    got = mc.solve(*[a[k] for k in ORDER], dt=300.0)
    want = muskingum.solve_block(*[a[k] for k in ORDER], dt=300.0,
                                 return_trips=True)
    _same(got, want[:3] + (want[7],), device != "cpu")
    rng = np.random.default_rng(4)
    p = np.stack([rng.uniform(1, 3, 50), np.full(50, 12.0),
                  np.full(50, 1.2), np.full(50, 0.1), np.full(50, 8.0),
                  np.full(50, 0.4), np.full(50, 11.0), np.full(50, 12.0),
                  np.full(50, 0.9)], 1)
    h = torch.as_tensor(rng.uniform(7.0, 13.0, 50), dtype=torch.float32,
                        device=device)
    q = torch.as_tensor(rng.uniform(0.0, 500.0, 50), dtype=torch.float32,
                        device=device)
    lp = LevelpoolParams.from_array(p, device=device, dtype=torch.float32)
    tab = torch.as_tensor(p, dtype=torch.float32, device=device)
    zero = torch.zeros_like(q)
    _same(levelpool.step(h, q, q, zero, 300.0, tab),
          levelpool_step(h, q, q, zero, 300.0, lp), device != "cpu")


def test_compaction_changes_no_value():
    _compaction("cpu")


def test_frozen_copies_match_the_programs_plain_versions():
    _frozen_vs_program("cpu")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    return "cuda"


@pytest.mark.cuda
def test_compaction_changes_no_value_on_the_card():
    _compaction(_card())


@pytest.mark.cuda
def test_frozen_copies_match_the_programs_plain_versions_on_the_card():
    _frozen_vs_program(_card())


def test_upstream_lists_from_ids():
    ids = np.array([50, 10, 30, 20, 40])
    down = np.array([0, 30, 50, 30, 999])    # 999 is outside: a tailwater
    up = mc_levelpool.upstream_lists(ids, down)
    assert up.tolist() == [[2, -1], [-1, -1], [1, 3], [-1, -1], [-1, -1]]


def test_outlets_and_basin_sums_from_ids():
    # two basins: 50 <- 30 <- {10, 20}, and 40 alone (999 is outside)
    ids = np.array([50, 10, 30, 20, 40])
    down = np.array([0, 30, 50, 30, 999])
    assert mc_levelpool.outlets(ids, down).tolist() == [0, 0, 0, 0, 4]
    chan = {k: np.ones(5, np.float32) for k in mc_levelpool.CHANNEL_KEYS}
    net = mc_levelpool.Network(ids, down, chan, [], np.zeros((0, 9)),
                               device="cpu")
    q = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0]])
    sums = net.basin_sums(q)
    assert sums.dtype == torch.float64 and sums.tolist() == [[10.0, 5.0]]
    assert mc_levelpool.basin_gap(sums, sums) == 0.0
    moved = sums.clone()
    moved[0, 1] += 0.05
    assert mc_levelpool.basin_gap(moved, sums) == pytest.approx(0.01)
    moved[0, 0] = float("nan")
    assert mc_levelpool.basin_gap(moved, sums) == float("inf")


def test_network_routes_lakes_and_segments():
    # 1 -> 2 (lake) -> 3; segment 4 -> 3
    ids = np.array([1, 2, 3, 4])
    down = np.array([2, 3, 0, 3])
    chan = {k: np.full(4, v, np.float32) for k, v in dict(
        dx=1000.0, bw=10.0, tw=30.0, twcc=100.0, n=0.055, ncc=0.11, cs=1.0,
        s0=0.005).items()}
    table = np.array([[2.0, 12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 0.9]])
    net = mc_levelpool.Network(ids, down, chan, [1], table, device="cpu")
    q = torch.tensor([1.0, 2.0, 3.0, 4.0])
    d = torch.tensor([0.5, 11.0, 0.5, 0.5])
    elev = torch.tensor([11.0])
    ql = torch.tensor([0.5, 0.0, 0.5, 0.5])
    q1, v1, d1, e1, evals = net.step(q, d, elev, ql, 300.0)
    out, e_want = levelpool.step(elev, q[:1], q[:1], torch.zeros(1), 300.0,
                                 torch.as_tensor(table, dtype=torch.float32))
    assert float(q1[1]) == float(out[0]) and float(v1[1]) == 0.0
    assert float(d1[1]) == float(e1[0]) == float(e_want[0])
    # segment 3 sees the lake's and segment 4's flows: 2 + 4
    want = mc.solve(*[torch.tensor([x]) for x in (6.0, 6.0, 3.0, 0.5)],
                    *[torch.tensor([chan[k][2]]) for k in (
                        "dx", "bw", "tw", "twcc", "n", "ncc", "cs", "s0")],
                    torch.tensor([0.5]), dt=300.0)
    assert float(q1[2]) == float(want[0][0])
    assert evals.shape == (3,)


def test_tally():
    t = mc_levelpool.Tally()
    t.flows(torch.tensor([1.0, 2.0, 0.0]), torch.tensor([1.0, 2.2, 0.0]))
    assert t.q_max_rel == pytest.approx(0.2 / 2.2)
    t.others(torch.tensor([1.0, 1.00001, 5.0, 0.0]),
             torch.tensor([1.0, 1.0, 4.0, 0.00001]))
    assert t.off == 3 and t.total == 7
    t.flows(torch.tensor([float("nan")]), torch.tensor([1.0]))
    t.others(torch.tensor([float("inf")]), torch.tensor([1.0]))
    assert t.numbers() == dict(q_max_rel=float("inf"), off_share=5 / 9)
    assert mc_levelpool.Tally().numbers()["off_share"] == float("inf")


def _flip_lane():
    """Two upstream lanes and one below them whose secant turns a change
    of one unit in the last place of its upstream inflow into a depth of
    5.8 m or 10.1 m (inputs of a CONUS lane seen on the card)."""
    ids, down = np.array([1, 2, 3]), np.array([3, 3, 0])
    chan = {k: np.full(3, v, np.float32) for k, v in dict(
        dx=504.9364929199219, bw=3.597839832305908, tw=36.796142578125,
        twcc=137.32965087890625, n=0.055, ncc=0.11, cs=0.4896610975265503,
        s0=0.014244725927710533).items()}
    net = mc_levelpool.Network(ids, down, chan, [], np.zeros((0, 9)),
                               device="cpu")
    q = torch.tensor([970.3687744140625, 0.0, 969.5176391601562])
    d = torch.tensor([1.0, 1.0, 10.143974304199219])
    ql = torch.tensor([0.5, 0.5, 1.2678354978561401])
    return net, q, d, ql


def test_explained_takes_a_last_bit_flip_and_nothing_else():
    net, q, d, ql = _flip_lane()
    want = net.step(q, d, torch.zeros(0), ql, 300.0)[:3]
    up = torch.nextafter(torch.tensor([970.3687744140625]),
                         torch.tensor([2000.0]))
    c = {k: v[2:3] for k, v in net.chan.items()}
    moved = mc.solve(up, up, q[2:], ql[2:], c["dx"], c["bw"], c["tw"],
                     c["twcc"], c["n"], c["ncc"], c["cs"], c["s0"], d[2:],
                     300.0)
    got = [w.clone() for w in want]
    for g, m in zip(got, moved[:3]):
        g[2] = m[0]
    assert abs(float(got[2][2]) - float(want[2][2])) > 1.0   # a flip
    ex = net.explained(q, d, ql, got, want, 300.0)
    assert ex.tolist() == [False, False, True]
    got[0][2] *= 1.5                                         # altered
    assert not net.explained(q, d, ql, got, want, 300.0).any()
    # a lane that agrees is not a candidate at all
    assert not net.explained(q, d, ql, want, want, 300.0).any()

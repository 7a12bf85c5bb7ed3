"""Tests of the port that need the card: kernels B1 and B2 against their
plain versions on the GPU, the level-pool kernel L1 in both forms against
the plain ``levelpool_step`` on the GPU bit for bit (f32 and f64), the
wrappers' launch accounting and checks, the
engine (short and strict modes, ``route()``'s level scan), the diffusive
solver (four configurations, a batch), the hybrid mainstem run and the
BMI's updates on the card against the CPU.

Run on a machine with a CUDA GPU and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

Elsewhere every test skips.  Tolerances as in ``test_torch_muskingum.py``,
``test_torch_engine.py`` and ``test_torch_strict.py``; a kernel and its
plain version on one card share libdevice's ``pow``, so they agree lane for
lane (B2 bit for bit in f32).

The strict engine, card against CPU, starts from one warm state (12 short
steps on the CPU), as production strict windows do: f64 rtol 1e-9 with
atol 1e-8 (ten times ``strict_tol``: a chunk boundary that falls on the
other side of the tolerance moves the committed iterate by
O(strict_tol)); f32 the f32 bar (rel diff median <= 1e-6, p95 <= 1e-5,
max <= 5e-2) with at most 1e-3 of the values past rtol/atol 1e-4.  The
f32 secant stops on a relative step, so its result jumps where a last-ulp
difference changes its trip count, and the strict fixed point moves with
it: on the CPU alone, the JAX package and the port from the same warm
state put 30 of this case's 60,000 f32 values past rtol/atol 1e-4 (max
rel 9.3e-4), flows among them.  From a cold random start even f64 lanes
jump: the JAX package and the port on the CPU reach fixed points 0.071
apart on 28 of 60,000 values, as the card and the CPU do.

The level scan and the diffusive solver are held to ``chip_smoke.py``'s
phase 9 and 10 bars (its helpers run them): the level scan from a warm
state, f64 rtol 1e-9 on all but 1e-5 of the values, f32 the strict f32
bar; the diffusive solver f64 rtol 1e-9 on all but 1e-5 of the values,
f32 the f32 bar on flows and surfaces within 1e-3 m, a batch equal to its
solo runs to rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import bench
from chip_smoke import conus_range_inputs, warm_step_args
from reservoir_da_lanes import da_lanes, plain_dispatch, same
from troute_torch import synthetic
from troute_torch.network.topology import build_topology_postorder
from troute_torch.ops import muskingum_cuda
from troute_torch.ops import muskingum as mc
from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.ops.muskingum import MCOutput, solve_block, solve_block_skip
from troute_torch.routing import engine

pytestmark = pytest.mark.cuda

DT = 300.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _conus_range(n, dtype, device):
    return [torch.as_tensor(a, dtype=dtype, device=device)
            for a in conus_range_inputs(n, seed=0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("diagnostics", [True, False])
def test_kernel_matches_plain_on_card(cuda, dtype, diagnostics):
    args = _conus_range(65536, dtype, cuda)
    got = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, with_diagnostics=diagnostics)
    torch.cuda.synchronize()
    want = solve_block(*args, dt=DT)
    n_out = 6 if diagnostics else 3
    for g, w in zip(got[:n_out], want[:n_out]):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-9 if dtype == torch.float64
                                   else 1e-6, atol=1e-12)
    for g in got[n_out:]:
        assert not bool(g.any())


def _b1_inputs(case, dtype, device):
    """B1's inputs for one case: the CONUS ranges, their first ``case``
    lanes (an int), retry-heavy lanes interleaved with no-flow lanes, or one
    warm short step of a 20,000-segment network routed on the card."""
    if case == "warm_step":
        n = 20_000
        ids, down = synthetic.synthetic_conus(n, n_basins=50)
        rng = np.random.default_rng(7)
        net = engine.network_arrays_from_topology(
            build_topology_postorder(ids, down), device=device)
        cp = engine.ChannelParams.from_arrays(
            device=device, dtype=dtype, **synthetic.channel_params(n, rng))
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa
        qlat = t(rng.uniform(0.1, 2.0, (2, n)))
        out = engine.route_stepped(
            net, cp, LevelpoolParams(*[t(np.ones(1))] * 9),
            engine.RoutingConfig(dt=DT, nts=12, qts_subdivisions=6,
                                 assume_short_ts=True),
            t(rng.uniform(0.5, 5.0, n)), t(rng.uniform(0.05, 0.8, n)),
            t(np.zeros(1)), qlat)
        return warm_step_args(net, cp, out["state"].q, out["state"].depth,
                              qlat[0])
    args = _conus_range(65536, dtype, device)
    if isinstance(case, int):
        return [a[:case].contiguous() for a in args]
    trips = solve_block(*args, dt=DT, return_trips=True)[6]
    heavy = torch.nonzero(trips > 100).flatten()
    assert heavy.numel() >= 8
    mix = []
    for k, a in enumerate(args):
        h = a[heavy]
        z = torch.zeros_like(h) if k < 4 else h  # qup, quc, qdp, ql
        mix.append(torch.stack([h, z], dim=1).reshape(-1).contiguous())
    return mix


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["conus_ranges", "warm_step", "retry_mix",
                                  0, 1, 31, 33, 257, 1003])
def test_b1_bits_and_trips_match_plain_on_card(cuda, dtype, case):
    """The persistent B1 against ``solve_block`` on the card: f32 bit for
    bit, f64 rtol 1e-9; per-lane trips and evaluations equal; two calls
    bit-identical (the order in which lanes are claimed changes nothing)."""
    args = _b1_inputs(case, dtype, cuda)
    got, trips, evals = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, return_trips=True)
    again, trips2, evals2 = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, return_trips=True)
    want = solve_block(*args, dt=DT, return_trips=True)
    torch.cuda.synchronize()
    assert trips.dtype == torch.int32 and evals.dtype == torch.int32
    assert torch.equal(trips, want[6]) and torch.equal(trips, trips2)
    assert torch.equal(evals, want[7]) and torch.equal(evals, evals2)
    if case == "retry_mix":
        assert int(trips[1::2].max()) == 0 and int(trips[::2].min()) > 100
    for g, a, w in zip(got, again, want[:6]):
        assert torch.equal(g, a)
        if dtype == torch.float32:
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=1e-9, atol=1e-12)


def test_launch_count_and_checks(cuda):
    args = _conus_range(1000, torch.float32, cuda)
    before = muskingum_cuda.LAUNCHES
    muskingum_cuda.muskingum_cunge_cuda(*args, DT)
    assert muskingum_cuda.LAUNCHES == before + 1
    empty = [a[:0] for a in args]
    out = muskingum_cuda.muskingum_cunge_cuda(*empty, DT)
    assert muskingum_cuda.LAUNCHES == before + 1 and out.qdc.shape == (0,)
    with pytest.raises(ValueError):
        muskingum_cuda.muskingum_cunge_cuda(args[0].cpu(), *args[1:], DT)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_route_stepped_card_matches_cpu(cuda, dtype):
    n, nts = 5000, 12
    ids, down = bench.synthetic_conus(n=n, n_basins=50)
    rng = np.random.default_rng(4)
    nt = np.zeros(n, np.int8)
    nt[rng.choice(np.flatnonzero(np.isin(ids, down)), 5, replace=False)] = 1
    topo = build_topology_postorder(ids, down, node_type=nt)
    chan = bench.channel_params(n, rng)
    lp = [rng.uniform(1.0, 3.0, 5)] + [np.full(5, v) for v in (
        12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 10.0)]
    q0, d0 = rng.uniform(0.5, 5.0, n), rng.uniform(0.05, 0.8, n)
    d0[topo.reservoir_rows] = 10.5
    qlat = rng.uniform(0.1, 2.0, (2, n))
    cfg = engine.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=6,
                               assume_short_ts=True, return_courant=True)

    def run(device):
        def t(a):
            return torch.as_tensor(a, dtype=dtype, device=device)
        out = engine.route_stepped(
            engine.network_arrays_from_topology(topo, device=device),
            engine.ChannelParams.from_arrays(device=device, dtype=dtype,
                                             **chan),
            LevelpoolParams(*[t(v) for v in lp]), cfg, t(q0), t(d0),
            t(np.full(5, 10.5)), t(qlat))
        return [out["flowveldepth"].cpu().numpy(),
                out["courant"].cpu().numpy(),
                out["state"].res_elev.cpu().numpy()]

    before = muskingum_cuda.LAUNCHES
    card = run(cuda)
    assert muskingum_cuda.LAUNCHES == before + nts
    for got, want in zip(card, run("cpu")):
        assert np.isfinite(got).all()
        if dtype == torch.float64:
            np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
        else:
            rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
            assert np.median(rel) <= 1e-6 and np.percentile(rel, 95) <= 1e-5
            assert rel.max() <= 5e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("diagnostics", [True, False])
def test_skip_kernel_matches_plain_on_card(cuda, dtype, diagnostics):
    """B2 against ``solve_block_skip`` on the card, a partial last block
    included: f32 bit for bit, f64 rtol 1e-9; active blocks equal B1,
    inactive blocks equal ``prev`` exactly."""
    n = 64 * muskingum_cuda.SKIP_BLOCK + 77
    args = _conus_range(n, dtype, cuda)
    full = muskingum_cuda.muskingum_cunge_cuda(*args, DT)
    prev = MCOutput(*[o + 7.0 + k for k, o in enumerate(full)])
    rng = np.random.default_rng(5)
    active = torch.as_tensor(rng.random(n) < 0.002, device=cuda)
    before = muskingum_cuda.SKIP_LAUNCHES
    got = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, with_diagnostics=diagnostics, active_rows=active,
        prev=prev)
    torch.cuda.synchronize()
    assert muskingum_cuda.SKIP_LAUNCHES == before + 1
    ran = muskingum_cuda.block_active_lanes(active)
    assert 0 < int(ran.sum()) < n
    want = solve_block_skip(*args, dt=DT, ran=ran, prev=prev)
    n_out = 6 if diagnostics else 3
    ran = ran.cpu().numpy()
    for k in range(n_out):
        g, w = got[k].cpu().numpy(), want[k].cpu().numpy()
        if dtype == torch.float32:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-12)
        np.testing.assert_array_equal(g[ran], full[k].cpu().numpy()[ran])
        np.testing.assert_array_equal(g[~ran], prev[k].cpu().numpy()[~ran])
    for g in got[n_out:]:
        assert not bool(g.any())


def _skip_pattern(name, n, device):
    """Per-lane activity for one named pattern of B2's flag blocks."""
    lane = torch.arange(n, device=device)
    block = lane // muskingum_cuda.SKIP_BLOCK
    if name == "all":
        return torch.ones(n, dtype=torch.bool, device=device)
    if name == "none":
        return torch.zeros(n, dtype=torch.bool, device=device)
    if name == "alternating":
        return block % 2 == 0
    if name == "random":
        rng = np.random.default_rng(11)
        return torch.as_tensor(rng.random(n) < 0.004, device=device)
    if name == "last_partial":    # only the last, partial block solves
        return lane == n - 1
    raise ValueError(name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("pattern", ["all", "none", "alternating", "random",
                                     "last_partial"])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 257, 100_003])
def test_b2_persistent_matches_plain_on_card(cuda, dtype, pattern, n):
    """The persistent B2 against ``solve_block_skip`` on the card, for each
    activity pattern and lane count (claims whose tail passes ``nseg``,
    flag blocks that are partial): f32 bit for bit, f64 rtol 1e-9; solved
    lanes equal B1, skipped lanes ``prev``, exactly; trips and evaluations
    equal B1's on solved lanes and 0 elsewhere; two calls identical.  The
    wrapper allocates the outputs, so ``prev`` never overlaps them (the
    strict engine hands the previous call's outputs over and keeps them)."""
    args = [a[:n].contiguous() for a in _conus_range(100_003, dtype, cuda)]
    full, f_trips, f_evals = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, return_trips=True)
    prev = MCOutput(*[o + 7.0 + k for k, o in enumerate(full)])
    active = _skip_pattern(pattern, n, cuda)
    ran = muskingum_cuda.block_active_lanes(active)
    before = muskingum_cuda.SKIP_LAUNCHES
    got, trips, evals = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, active_rows=active, prev=prev, return_trips=True)
    again, trips2, evals2 = muskingum_cuda.muskingum_cunge_cuda(
        *args, DT, active_rows=active, prev=prev, return_trips=True)
    torch.cuda.synchronize()
    assert muskingum_cuda.SKIP_LAUNCHES == before + (2 if n else 0)
    assert all(p.data_ptr() != g.data_ptr() for p, g in zip(prev, got) if n)
    want = solve_block_skip(*args, dt=DT, ran=ran, prev=prev,
                            return_trips=True)
    assert torch.equal(trips, torch.where(ran, f_trips, 0))
    assert torch.equal(evals, torch.where(ran, f_evals, 0))
    assert torch.equal(trips, trips2) and torch.equal(evals, evals2)
    assert torch.equal(trips, want[6]) and torch.equal(evals, want[7])
    for g, a, w, f, p in zip(got, again, want[:6], full, prev):
        assert torch.equal(g, a)
        if dtype == torch.float32:
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=1e-9, atol=1e-12)
        assert torch.equal(g[ran], f[ran]) and torch.equal(g[~ran], p[~ran])


def _strict_case(n, seed):
    ids, down = bench.synthetic_conus(n=n, n_basins=50)
    rng = np.random.default_rng(seed)
    nt = np.zeros(n, np.int8)
    nt[rng.choice(np.flatnonzero(np.isin(ids, down)), 5, replace=False)] = 1
    topo = build_topology_postorder(ids, down, node_type=nt)
    chan = bench.channel_params(n, rng)
    lp = [rng.uniform(1.0, 3.0, 5)] + [np.full(5, v) for v in (
        12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 10.0)]
    q0, d0 = rng.uniform(0.5, 5.0, n), rng.uniform(0.05, 0.8, n)
    d0[topo.reservoir_rows] = 10.5
    gage_rows = rng.choice(np.flatnonzero(nt == 0), 10, replace=False)
    obs = rng.uniform(1.0, 10.0, (5, 10))
    obs[rng.random(obs.shape) < 0.4] = np.nan
    return topo, chan, lp, q0, d0, rng.uniform(0.1, 2.0, (2, n)), \
        gage_rows, obs


def _route_strict(case, cfg, dtype, device, warm=None):
    """``route_stepped`` on ``case`` from its initial state, or from the
    ``RoutingState`` ``warm`` (copied to ``device``)."""
    topo, chan, lp, q0, d0, qlat, gage_rows, obs = case

    def t(a, dt=dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dt)
        return torch.as_tensor(a, dtype=dt, device=device)

    if warm is None:
        warm = engine.RoutingState(q=q0, depth=d0, res_elev=np.full(5, 10.5),
                                   lastobs_val=np.full(10, 2.0),
                                   lastobs_time=np.full(10, -600.0))
    da = engine.GageDA(rows=t(gage_rows, torch.int64), obs=t(obs),
                       lastobs_val=t(warm.lastobs_val),
                       lastobs_time=t(warm.lastobs_time), decay_coeff=120.0)
    return engine.route_stepped(
        engine.network_arrays_from_topology(topo, device=device),
        engine.ChannelParams.from_arrays(device=device, dtype=dtype, **chan),
        LevelpoolParams(*[t(v) for v in lp]), cfg, t(warm.q), t(warm.depth),
        t(warm.res_elev), t(qlat), da)


def _assert_f32_bar(got, want):
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert np.median(rel) <= 1e-6 and np.percentile(rel, 95) <= 1e-5
    assert rel.max() <= 5e-2
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert off.sum() <= 1e-3 * off.size, int(off.sum())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("gs", [False, True])
def test_strict_card_matches_cpu_and_counts(cuda, dtype, gs, monkeypatch):
    """Strict ``route_stepped`` (block skip and accelerator on, or GS) on
    the card against the CPU from one warm state; the card's B1 and B2
    launches equal the driver's own MC call counts, and the plain
    ``solve_block`` never runs on a CUDA tensor."""
    case = _strict_case(5000, 6)
    warm = _route_strict(case, engine.RoutingConfig(
        dt=DT, nts=12, qts_subdivisions=6, assume_short_ts=True), dtype,
        "cpu")["state"]
    cfg = engine.RoutingConfig(dt=DT, nts=4, qts_subdivisions=2,
                               assume_short_ts=False, strict_iterative=True,
                               strict_block_skip=True, strict_gs=gs)
    plain = mc.solve_block

    def cpu_only(*a, **kw):
        assert a[0].device.type == "cpu", "plain solve on a CUDA tensor"
        return plain(*a, **kw)

    monkeypatch.setattr(mc, "solve_block", cpu_only)
    b1, b2 = muskingum_cuda.LAUNCHES, muskingum_cuda.SKIP_LAUNCHES
    card = _route_strict(case, cfg, dtype, cuda, warm)
    torch.cuda.synchronize()
    calls = card["strict_mc_calls"]
    assert muskingum_cuda.LAUNCHES - b1 == calls["mc_secant"]
    assert muskingum_cuda.SKIP_LAUNCHES - b2 == calls["mc_secant_skip"]
    assert (calls["mc_secant_skip"] > 0) == (not gs)
    cpu = _route_strict(case, cfg, dtype, "cpu", warm)
    # every output value of the run as one vector, as chip_smoke.py does
    got, want = [np.concatenate([out[k].cpu().numpy().ravel()
                                 for k in ("flowveldepth", "nudge")])
                 for out in (card, cpu)]
    assert np.isfinite(got).all()
    if dtype == torch.float64:
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-8)
    else:
        _assert_f32_bar(got, want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_level_scan_card_matches_cpu(cuda, dtype):
    """``route()``'s level scan on a small regional network with
    reservoirs and gages, from a warm state: B1 launched once per level
    row per step, and the card against the CPU at ``chip_smoke.py``'s
    phase 9 bars."""
    from chip_smoke import (_network, _route, _run_values, _state_dict,
                            _warm_state, check_f64_network,
                            check_strict_f32, regional_network)
    case = _network(4000, n_res=20, n_gage=20, seed=9,
                    conn=regional_network(4000, 40, seed=9))
    start = _state_dict(_warm_state("cpu", dtype, case))
    before = muskingum_cuda.LAUNCHES
    card = _route(cuda, dtype, case, 4, levels=True, start=start)
    rows = int(card["net"].level_nodes.shape[0])
    assert muskingum_cuda.LAUNCHES - before == card["mc_calls"] == 4 * rows
    cpu = _route("cpu", dtype, case, 4, levels=True, start=start)
    got, want = _run_values(card), _run_values(cpu)
    if dtype == torch.float64:
        check_f64_network(got, want, "level scan f64")
    else:
        check_strict_f32(got, want, "level scan f32")


@pytest.mark.parametrize("dtype, mode, nel", [
    ("float32", "jacobi", 128), ("float32", "jacobi", None),
    ("float64", "jacobi", None), ("float64", "wavefront", None)])
def test_diffusive_card_matches_cpu(cuda, dtype, mode, nel):
    """The diffusive solver on a small mainstem tree (R=32, C=16, 4 steps),
    card against CPU at ``chip_smoke.py``'s phase 10 bars."""
    from chip_smoke import (_diffusive_bars, _diffusive_run,
                            _diffusive_values)
    runs = [_diffusive_run(d, getattr(torch, dtype), mode, nel, 32, 16, 4)
            for d in (cuda, "cpu")]
    _diffusive_bars(*[_diffusive_values(r[0], r[3]) for r in runs], dtype,
                    f"diffusive {dtype} {mode} {nel}")


def test_diffusive_batched_on_card_matches_solo(cuda):
    from chip_smoke import _diffusive_batched
    _diffusive_batched(cuda, 3, 16, 16, 4, "card test")


@pytest.mark.parametrize("dtype_s, nel", [("float64", 0), ("float32", 128)])
def test_run_mainstem_card_matches_cpu(cuda, tmp_path, dtype_s, nel):
    """``routing/hybrid.py:run_mainstem`` on two trees of
    ``synthetic.hybrid_regional`` (10,000 segments, MC flows of 4 steps
    routed on the CPU), card against CPU at ``chip_smoke.py``'s phase 10
    bars."""
    from chip_smoke import (_diffusive_bars, _hybrid_case, _hybrid_mc,
                            _mainstem_values)
    from troute_torch.config.schema import HybridParameters
    from troute_torch.routing.hybrid import run_mainstem
    case = _hybrid_case("cpu", 10_000, 10, 2, tmp_path)
    fvd, _ = _hybrid_mc("cpu", case, 4)
    hp = HybridParameters(diffusive_dtype=dtype_s, diffusive_table_nel=nel)
    runs = [run_mainstem(case["hyb"], fvd, np.asarray(case["topo"].ids),
                         case["mc"]["q0"], 1.0, DT, 12, hp, d)
            for d in (cuda, "cpu")]
    assert runs[0]["dtype"] == dtype_s
    _diffusive_bars(*[_mainstem_values(r) for r in runs], dtype_s,
                    f"run_mainstem {dtype_s}")


@pytest.mark.parametrize("mode", ["short", "fixed point"])
def test_bmi_update_card_matches_cpu(cuda, tmp_path, mode):
    """``BmiTroute`` on a 5,000-segment regional network with 20 lakes, 2
    updates of 2 steps on the card against the CPU: short mode at the f32
    bar, ``assume_short_ts: False`` (from a warm state) at the strict f32
    bar; B1 launched once per short step."""
    import yaml
    from chip_smoke import (_bmi, _bmi_network, _bmi_values, _warm_copy,
                            check_f32_bar, check_strict_f32)
    pushes, qlat = _bmi_network(5_000, 5, 20, seed=9)
    path = ""
    warm = None
    if mode == "fixed point":
        path = str(tmp_path / "strict.yaml")
        yaml.safe_dump({"compute_parameters": {
            "assume_short_ts": False,
            "forcing_parameters": {"dt": DT, "nts": 4}}}, open(path, "w"))
        warm = _bmi("cpu", pushes, qlat)
        warm.update_until(12 * DT)
    vals = []
    for dev in (cuda, "cpu"):
        bmi = _bmi(dev, pushes, qlat, path)
        if warm is not None:
            _warm_copy(warm, bmi, dev)
        before = muskingum_cuda.LAUNCHES
        v = []
        for k in (1, 2):
            bmi.update_until(2 * k * DT)
            v.append(_bmi_values(bmi))
        if mode == "short" and dev == cuda:
            assert muskingum_cuda.LAUNCHES - before == 4
        vals.append(np.concatenate(v))
    if mode == "short":
        check_f32_bar(*vals, "BMI short card vs cpu", max_share=1e-5)
    else:
        check_strict_f32(*vals, "BMI fixed point card vs cpu")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_route_sharded_global_nccl_world_1_equals_route_stepped(
        cuda, tmp_path, dtype):
    """A 1-rank NCCL group on the card: ``route_sharded_global`` in short
    mode (5,000 segments, lakes and gages) bit for bit equal to
    ``route_stepped``, with B1 launched once per step."""
    import torch.distributed as dist

    from troute_torch.parallel.group import init_group
    from troute_torch.parallel.sharded_engine import route_sharded_global
    case = _strict_case(5000, 3)
    topo, chan, lp, q0, d0, qlat, gage_rows, obs = case
    cfg = engine.RoutingConfig(dt=DT, nts=4, qts_subdivisions=2,
                               assume_short_ts=True)
    want = _route_strict(case, cfg, dtype, cuda)
    da = engine.GageDA(
        rows=torch.as_tensor(gage_rows, device=cuda),
        obs=torch.as_tensor(obs, dtype=dtype, device=cuda),
        lastobs_val=torch.full((10,), 2.0, dtype=dtype, device=cuda),
        lastobs_time=torch.full((10,), -600.0, dtype=dtype, device=cuda),
        decay_coeff=120.0)
    init_group(cuda, "nccl", init_method=f"file://{tmp_path}/store", rank=0,
               world_size=1)
    try:
        before = muskingum_cuda.LAUNCHES
        got = route_sharded_global(
            None, topo, chan, np.stack(lp, axis=1), cfg,
            torch.as_tensor(q0, dtype=dtype, device=cuda), d0,
            np.full(5, 10.5), qlat, da=da, dtype=dtype, device=cuda)
        torch.cuda.synchronize()
        assert muskingum_cuda.LAUNCHES == before + cfg.nts
        assert got["mc_calls"] == cfg.nts
    finally:
        dist.destroy_process_group()
    assert torch.equal(got["flowveldepth"], want["flowveldepth"])
    assert torch.equal(got["nudge"], want["nudge"])
    for f in ("q", "depth", "res_elev", "lastobs_val", "lastobs_time"):
        assert torch.equal(getattr(got["state"], f),
                           getattr(want["state"], f)), f


# LevelpoolParams' columns (area, max_depth, orifice_area, orifice_coeff,
# orifice_elev, weir_coeff, weir_elev, weir_length, ifd) drawn as in
# test_torch_ops.py's branch test
_LP_RANGES = ((0.5, 20.0), (9.0, 11.0), (0.5, 2.0), (0.05, 0.2), (6.0, 8.0),
              (0.3, 0.5), (8.5, 9.5), (5.0, 20.0), (0.0, 1.0))
_LP_BRANCHES = ("overtop", "weir_orifice", "orifice", "below_orifice",
                "no_area", "edges")


def _lp_lanes(dtype, device, per_branch=2000, seed=11):
    """Lakes whose elevations put the first discharge evaluation on each
    branch of ``_discharge`` (over the top, weir and orifice, orifice
    only, below the orifice), lakes of zero area, and lakes that sit
    exactly on the three thresholds; the parameters as column views of
    one [n, 9] array, as ``from_array`` makes them.  Returns (H, qi0,
    qi1, ql, params, branch of each lake)."""
    rng = np.random.default_rng(seed)
    wb, h, branch = [], [], []
    for b in _LP_BRANCHES:
        w = np.stack([rng.uniform(lo, hi, per_branch)
                      for lo, hi in _LP_RANGES], axis=1)
        # the weir crest below the top of storage
        w[:, 1] = np.maximum(w[:, 1], w[:, 6] + 0.2)
        md, oe, we = w[:, 1], w[:, 4], w[:, 6]
        between = rng.uniform(0.05, 0.95, per_branch)
        if b == "overtop":
            x = md + rng.uniform(0.01, 1.0, per_branch)
        elif b == "weir_orifice":
            x = we + (md - we) * between
        elif b == "orifice":
            x = oe + (we - oe) * between
        elif b == "below_orifice":
            x = oe - rng.uniform(0.01, 2.0, per_branch)
        elif b == "no_area":
            w[:, 0] = 0.0
            x = rng.uniform(5.0, 12.0, per_branch)
        else:
            x = np.choose(np.arange(per_branch) % 3, [md, we, oe])
        wb.append(w)
        h.append(x)
        branch += [b] * per_branch
    wb, h = np.concatenate(wb), np.concatenate(h)
    n = h.size

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return (t(h), t(rng.uniform(0, 500, n)), t(rng.uniform(0, 500, n)),
            t(rng.uniform(0, 5, n)),
            LevelpoolParams.from_array(wb, device=device, dtype=dtype),
            np.asarray(branch))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_levelpool_lane_form_bits_match_plain_on_card(cuda, dtype):
    """Kernel L1's lane form against the plain ``levelpool_step`` run on
    the same card, bit for bit, on every branch of the discharge: with
    lateral inflow, without (``ql`` None reads zeros), and with the
    parameters as separate contiguous tensors; one launch a call."""
    from troute_torch.ops import levelpool_cuda
    from troute_torch.ops.levelpool import levelpool_step
    H, qi0, qi1, ql, p, branch = _lp_lanes(dtype, cuda)
    assert p.area.stride(0) == 9
    before = levelpool_cuda.LAUNCHES
    got = levelpool_cuda.levelpool_step_cuda(H, qi0, qi1, ql, DT, p)
    got0 = levelpool_cuda.levelpool_step_cuda(H, qi0, qi1, None, DT, p)
    flat = LevelpoolParams(*[c.contiguous() for c in p])
    got_c = levelpool_cuda.levelpool_step_cuda(H, qi0, qi1, ql, DT, flat)
    want = levelpool_step(H, qi0, qi1, ql, DT, p)
    want0 = levelpool_step(H, qi0, qi1, torch.zeros_like(ql), DT, p)
    torch.cuda.synchronize()
    assert levelpool_cuda.LAUNCHES == before + 3
    for g, g0, gc, w, w0 in zip(got, got0, got_c, want, want0):
        assert g.dtype == dtype and g.device == H.device
        assert torch.equal(g, w) and torch.equal(gc, w)
        assert torch.equal(g0, w0)
    out, h_new = (a.cpu().numpy() for a in got)
    assert np.isfinite(out).all() and np.isfinite(h_new).all()
    for b in ("overtop", "weir_orifice", "orifice"):
        assert (out[branch == b] > 0).all(), b


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("scatter", [True, False])
def test_levelpool_row_form_bits_match_plain_on_card(cuda, dtype, scatter):
    """Kernel L1's row form (the short step's gather, level pool and, with
    ``into``, its two scatters) against ``quc[rows]``, the plain
    ``levelpool_step`` with zero lateral inflow and ``index_put`` on the
    same card, bit for bit (with ``into`` it returns the new elevation
    alone); rows in a scattered order; one launch."""
    from troute_torch.ops import levelpool_cuda
    from troute_torch.ops.levelpool import levelpool_step
    H, _, _, _, p, _ = _lp_lanes(dtype, cuda)
    n = H.shape[0]
    rng = np.random.default_rng(12)
    n_nodes = 3 * n
    rows = torch.as_tensor(rng.choice(n_nodes, n, replace=False),
                           device=cuda)
    quc, q, d = (torch.as_tensor(rng.uniform(0, 500, n_nodes), dtype=dtype,
                                 device=cuda) for _ in range(3))
    q_in, d_in = q.clone(), d.clone()
    before = levelpool_cuda.LAUNCHES
    got = levelpool_cuda.levelpool_rows_cuda(
        H, quc, rows, DT, p, into=(q_in, d_in) if scatter else None)
    inflow = quc[rows]
    out, h_new = levelpool_step(H, inflow, inflow, torch.zeros_like(inflow),
                                DT, p)
    torch.cuda.synchronize()
    assert levelpool_cuda.LAUNCHES == before + 1
    if scatter:
        assert torch.equal(got, h_new)
        assert torch.equal(q_in, q.index_put((rows,), out))
        assert torch.equal(d_in, d.index_put((rows,), h_new))
    else:
        for g, w in zip(got, (out, h_new, inflow)):
            assert torch.equal(g, w)
        assert torch.equal(q_in, q) and torch.equal(d_in, d)


def test_levelpool_params_written_in_place_on_card(cuda):
    """The wrapper packs a parameter set once and keeps it; after a field
    is written in place the kernel reads the new values, bit for bit with
    the plain ``levelpool_step`` on the same card."""
    from troute_torch.ops import levelpool_cuda
    from troute_torch.ops.levelpool import levelpool_step
    H, qi0, qi1, ql, p, _ = _lp_lanes(torch.float32, cuda, per_branch=64)
    first = levelpool_cuda.levelpool_step_cuda(H, qi0, qi1, ql, DT, p)
    p.weir_elev.sub_(0.5)
    p.area.mul_(2.0)
    got = levelpool_cuda.levelpool_step_cuda(H, qi0, qi1, ql, DT, p)
    want = levelpool_step(H, qi0, qi1, ql, DT, p)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(first[0], got[0])


def test_levelpool_zero_lakes_and_checks(cuda):
    """No lakes: empty outputs and no launch.  The wrapper raises, before
    any launch, on tensors of mixed devices or dtypes, on a shape that
    differs, on rows that are not int64 on the lakes' device, and on
    ``into`` tensors that alias ``quc``."""
    from troute_torch.ops import levelpool_cuda
    H, qi0, qi1, ql, p, _ = _lp_lanes(torch.float32, cuda, per_branch=8)
    rows = torch.arange(H.shape[0], device=cuda)
    quc = torch.ones(2 * H.shape[0], device=cuda)
    before = levelpool_cuda.LAUNCHES
    e = H[:0]
    p0 = LevelpoolParams(*[c[:0] for c in p])
    out, h_new = levelpool_cuda.levelpool_step_cuda(e, e, e, None, DT, p0)
    assert out.shape == h_new.shape == (0,)
    got = levelpool_cuda.levelpool_rows_cuda(
        e, quc, rows[:0], DT, p0, into=(quc.clone(), quc.clone()))
    assert got.shape == (0,)
    got = levelpool_cuda.levelpool_rows_cuda(e, quc, rows[:0], DT, p0)
    assert all(g.shape == (0,) for g in got) and len(got) == 3
    bad = [
        lambda: levelpool_cuda.levelpool_step_cuda(H.cpu(), qi0, qi1, ql,
                                                   DT, p),
        lambda: levelpool_cuda.levelpool_step_cuda(H, qi0.double(), qi1, ql,
                                                   DT, p),
        lambda: levelpool_cuda.levelpool_step_cuda(H, qi0[1:], qi1, ql, DT,
                                                   p),
        lambda: levelpool_cuda.levelpool_step_cuda(
            H, qi0, qi1, ql, DT, p._replace(area=p.area.cpu())),
        lambda: levelpool_cuda.levelpool_rows_cuda(H, quc, rows.cpu(), DT, p),
        lambda: levelpool_cuda.levelpool_rows_cuda(H, quc, rows.int(), DT, p),
        lambda: levelpool_cuda.levelpool_rows_cuda(H, quc.double(), rows, DT,
                                                   p),
        lambda: levelpool_cuda.levelpool_rows_cuda(H, quc, rows, DT, p,
                                                   into=(quc, quc.clone())),
    ]
    for call in bad:
        with pytest.raises((ValueError, TypeError)):
            call()
    torch.cuda.synchronize()
    assert levelpool_cuda.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form", ["lanes", "rows"])
def test_levelpool_da_bits_match_plain_on_card(cuda, dtype, form):
    """Kernel L1's DA form against kernel L1 without DA, then the plain
    ``typed_reservoir_dispatch`` and, in the row form, ``index_put``, on
    the same card, bit for bit (NaN where NaN): the outflow, elevation and
    depth column (row form: the elevation and the two node tensors it
    scatters into), and all nine DA state fields, on lakes that take every
    branch of each DA kind and level-pool lakes
    (``reservoir_da_lanes.BRANCHES``, rows in a scattered order); the
    caller's states untouched; one launch, counted as a DA launch too."""
    from troute_torch.ops import levelpool_cuda
    x = da_lanes(dtype, cuda, per_branch=64, seed=5)
    H, inflow, p, rd, st = (x[k] for k in ("H", "inflow", "p", "res_da",
                                          "states"))
    now, month, branch = x["now"], x["month_i"], x["branch"]
    kept = [[f.clone() for f in s] for s in st]
    n = H.shape[0]
    before = (levelpool_cuda.LAUNCHES, levelpool_cuda.DA_LAUNCHES)
    if form == "rows":
        rng = np.random.default_rng(9)
        rows = torch.as_tensor(rng.choice(3 * n, n, replace=False),
                               device=cuda)
        quc, q, d = (torch.as_tensor(rng.uniform(0, 500, 3 * n), dtype=dtype,
                                     device=cuda) for _ in range(3))
        quc = quc.index_put((rows,), inflow)
        q_in, d_in = q.clone(), d.clone()
        elev, states = levelpool_cuda.levelpool_da_rows_cuda(
            H, quc, rows, DT, p, rd, st, now, month, into=(q_in, d_in))
        torch.cuda.synchronize()
        after = (levelpool_cuda.LAUNCHES, levelpool_cuda.DA_LAUNCHES)
        lp_out, lp_elev, lake_in = levelpool_cuda.levelpool_rows_cuda(
            H, quc, rows, DT, p)
        got = (q_in[rows], elev, d_in[rows])
    else:
        *got, states = levelpool_cuda.levelpool_da_step_cuda(
            H, inflow, DT, p, rd, st, now, month)
        torch.cuda.synchronize()
        after = (levelpool_cuda.LAUNCHES, levelpool_cuda.DA_LAUNCHES)
        lake_in = inflow
        lp_out, lp_elev = levelpool_cuda.levelpool_step_cuda(
            H, inflow, inflow, None, DT, p)
    assert after == (before[0] + 1, before[1] + 1)
    out, w_elev, d_scat, *w_states = plain_dispatch(
        rd, st, H, lake_in, lp_out, lp_elev, now, month, p, DT)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, (out, w_elev, d_scat))):
        off = ~((g == w) | (torch.isnan(g) & torch.isnan(w)))
        assert same(g, w), (k, sorted(set(branch[off.cpu().numpy()])))
    if form == "rows":
        others = torch.ones(3 * n, dtype=torch.bool, device=cuda)
        others[rows] = False
        assert torch.equal(q_in[others], q[others])
        assert torch.equal(d_in[others], d[others])
    for gs, ws in zip(states, w_states):
        for f, g, w in zip(gs._fields, gs, ws):
            assert same(g, w), f
    for s, k in zip(st, kept):
        for f, c in zip(s, k):
            assert same(f, c)


def test_levelpool_da_zero_lakes_and_checks(cuda):
    """No lakes: empty outputs and states and no launch.  The DA wrappers
    raise, before any launch, on a state of another shape or dtype, a
    float RFC index, a month outside the climatology, DA inputs of another
    dtype or on the CPU, an observation matrix with no column, lake
    tensors on the CPU, and the row form without ``into``."""
    from troute_torch.ops import levelpool_cuda
    x = da_lanes(torch.float32, cuda, per_branch=2)
    H, inflow, p, rd, st = (x[k] for k in ("H", "inflow", "p", "res_da",
                                          "states"))
    now, month = x["now"], x["month_i"]
    rows = torch.arange(H.shape[0], device=cuda)
    quc = torch.ones(2 * H.shape[0], device=cuda)
    into = (quc.clone(), quc.clone())
    before = (levelpool_cuda.LAUNCHES, levelpool_cuda.DA_LAUNCHES)
    e = H[:0]
    p0 = LevelpoolParams(*[c[:0] for c in p])
    rd0 = rd._replace(**{f: getattr(rd, f)[:0] for f in rd._fields
                         if f not in engine._RES_DA_SHARED})
    st0 = tuple(type(s)(*[f[:0] for f in s]) for s in st)
    got = levelpool_cuda.levelpool_da_step_cuda(e, e, DT, p0, rd0, st0, now,
                                                month)
    assert all(g.shape == (0,) for g in got[:3])
    assert all(f.shape == (0,) for s in got[3] for f in s)
    elev, states = levelpool_cuda.levelpool_da_rows_cuda(
        e, quc, rows[:0], DT, p0, rd0, st0, now, month, into=into)
    assert elev.shape == (0,) and states[1].timeseries_idx.dtype == torch.int32
    hyb, rfc, gl = st
    bad = [
        dict(states=(hyb._replace(update_time=hyb.update_time[1:]), rfc, gl)),
        dict(states=(hyb, rfc, gl._replace(update_time=gl.update_time.double()
                                           ))),
        dict(states=(hyb, rfc._replace(timeseries_idx=rfc.update_time), gl)),
        dict(month_i=12),
        dict(res_da=rd._replace(rfc_timestep=rd.rfc_timestep.double())),
        dict(res_da=rd._replace(gl_climatology=rd.gl_climatology.cpu())),
        dict(res_da=rd._replace(rfc_series=rd.rfc_series[:, :0])),
    ]
    for kw in bad:
        args = dict(res_da=rd, states=st, now=now, month_i=month) | kw
        with pytest.raises((ValueError, TypeError, IndexError)):
            levelpool_cuda.levelpool_da_step_cuda(H, inflow, DT, p, **args)
        with pytest.raises((ValueError, TypeError, IndexError)):
            levelpool_cuda.levelpool_da_rows_cuda(H, quc, rows, DT, p,
                                                  **args, into=into)
    for call in (
            lambda: levelpool_cuda.levelpool_da_step_cuda(
                H, inflow.cpu(), DT, p, rd, st, now, month),
            lambda: levelpool_cuda.levelpool_da_rows_cuda(
                H, quc, rows.cpu(), DT, p, rd, st, now, month, into=into),
            lambda: levelpool_cuda.levelpool_da_rows_cuda(
                H, quc, rows, DT, p, rd, st, now, month, into=None)):
        with pytest.raises(ValueError):
            call()
    torch.cuda.synchronize()
    assert (levelpool_cuda.LAUNCHES, levelpool_cuda.DA_LAUNCHES) == before


def _on(obj, device):
    """Tensors of ``obj`` (nested named tuples and tuples) on ``device``,
    the host month table excepted."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if hasattr(obj, "_fields"):
        return type(obj)(*[v if f == "month_idx" else _on(v, device)
                           for f, v in zip(obj._fields, obj)])
    if isinstance(obj, tuple):
        return tuple(_on(v, device) for v in obj)
    return obj


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_hourly_da_on_card_equals_the_plain_block(cuda, dtype, monkeypatch):
    """NWM's analysis hours on the card (``test_torch_da_hourly.Case``:
    gages, persistence, RFC and Great Lakes lakes): two 1-hour
    ``route_stepped`` calls joined by ``da_handoff`` with the DA form of
    kernel L1, and the same with the engine's lake block as it was before
    it (kernel L1's row form, the plain ``typed_reservoir_dispatch`` and
    out-of-place ``index_put`` on the card): flows, nudges, states and the
    DA handed on, bit for bit (NaN where NaN).  One DA launch a step, by
    the wrapper's count and, under a profiler, by
    ``engine.reservoir_da_launches``; the caller's ``*_state0`` tensors
    unchanged."""
    from torch.profiler import ProfilerActivity, profile

    import test_torch_da_hourly as hourly
    from troute_torch import tracing
    from troute_torch.ops import levelpool_cuda
    c = hourly.Case(3, dtype)
    da, res = _on(c.program_da(), cuda)
    kept = _on((res.hybrid_state0, res.rfc_state0, res.gl_state0), "cpu")
    net = engine.network_arrays_from_topology(c.topo, device=cuda)
    chan, lp = _on(c.chan, cuda), _on(c.lp, cuda)
    ql = c.ql[:, c.canon].to(cuda)
    q0, d0, e0 = (a.to(cuda) for a in c.start())
    cfg = engine.RoutingConfig(dt=hourly.DT, nts=hourly.STEPS,
                               qts_subdivisions=hourly.STEPS,
                               assume_short_ts=True)

    def two_hours():
        first = engine.route_stepped(net, chan, lp, cfg, q0, d0, e0, ql, da,
                                     res)
        st = first["state"]
        da1, res1 = engine.da_handoff(da, res, st, hourly.STEPS, hourly.HOUR)
        second = engine.route_stepped(net, chan, lp, cfg, st.q, st.depth,
                                      st.res_elev, ql[1:], da1, res1)
        return (first, second,
                engine.da_handoff(da1, res1, second["state"], hourly.STEPS,
                                  hourly.HOUR))

    tracing.drain()
    before = levelpool_cuda.DA_LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]):
        got = two_hours()
        torch.cuda.synchronize()
    assert levelpool_cuda.DA_LAUNCHES - before == 2 * hourly.STEPS
    assert tracing.drain()[1]["engine.reservoir_da_launches"] \
        == 2 * hourly.STEPS
    hourly._equal_da(_on((res.hybrid_state0, res.rfc_state0, res.gl_state0),
                         "cpu"), kept, "caller's states")

    def plain_block(H, quc, rows, dt, p, res_da, states, now, month_i, *,
                    into):
        lp_out, lp_elev, inflow = levelpool_cuda.levelpool_rows_cuda(
            H, quc, rows, dt, p)
        out, elev, d_scat, *states = plain_dispatch(
            res_da, states, H, inflow, lp_out, lp_elev, now, month_i, p, dt)
        for a, v in zip(into, (out, d_scat)):
            a.copy_(a.index_put((rows,), v))
        return elev, tuple(states)

    monkeypatch.setattr(engine, "levelpool_da_rows_cuda", plain_block)
    want = two_hours()
    torch.cuda.synchronize()
    assert levelpool_cuda.DA_LAUNCHES - before == 2 * hourly.STEPS
    for h in range(2):
        for k in ("flowveldepth", "nudge"):
            hourly._equal(got[h][k], want[h][k], f"hour {h} {k}")
        hourly._equal_da(got[h]["state"], want[h]["state"], f"hour {h}")
    hourly._equal_da(got[2], want[2], "handed on")
    st = got[1]["state"]
    assert (st.rfc.timeseries_idx > 28).any()
    assert torch.isfinite(st.hybrid.persisted_outflow).any()
    assert torch.isfinite(st.gl.assimilated_outflow).any()


def _lake_route_case(n, n_res, seed):
    """A CONUS-like network (``synthetic_conus``) with ``n_res`` lakes on
    segments that have an upstream, and its channel, lake and forcing
    arrays."""
    ids, down = bench.synthetic_conus(n=n, n_basins=50)
    rng = np.random.default_rng(seed)
    nt = np.zeros(n, np.int8)
    nt[rng.choice(np.flatnonzero(np.isin(ids, down)), n_res,
                  replace=False)] = 1
    topo = build_topology_postorder(ids, down, node_type=nt)
    wb = np.stack([rng.uniform(lo, hi, n_res) for lo, hi in _LP_RANGES],
                  axis=1)
    elev0 = rng.uniform(wb[:, 4] - 0.5, wb[:, 1] + 0.2)
    q0, d0 = rng.uniform(0.5, 5.0, n), rng.uniform(0.05, 0.8, n)
    d0[topo.reservoir_rows] = elev0
    return (topo, bench.channel_params(n, rng), wb, q0, d0, elev0,
            rng.uniform(0.1, 2.0, (3, n)))


def _lake_route(case, dtype, device, nts, with_da):
    """``route_stepped`` on ``case``: short steps; with ``with_da`` a third
    of the lakes USGS persistence lakes with 15-min observations, the rest
    level pool, through the typed reservoir DA."""
    topo, chan, wb, q0, d0, elev0, qlat = case

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    n_res = wb.shape[0]
    res_da = None
    if with_da:
        rng = np.random.default_rng(5)
        kind = np.where(np.arange(n_res) % 3 == 0, 2, 1)
        res_da = engine.ReservoirDAData.inactive(
            n_res, nts, device=device, dtype=dtype)._replace(
            wbody_type=torch.as_tensor(kind, dtype=torch.int32,
                                       device=device),
            hybrid_obs=t(rng.uniform(1.0, 30.0, (n_res, 8))),
            hybrid_obs_time=t(np.arange(8) * 900.0 - 3600.0))
    cfg = engine.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=6,
                               assume_short_ts=True)
    return engine.route_stepped(
        engine.network_arrays_from_topology(topo, device=device),
        engine.ChannelParams.from_arrays(device=device, dtype=dtype, **chan),
        LevelpoolParams.from_array(wb, device=device, dtype=dtype), cfg,
        t(q0), t(d0), t(elev0), t(qlat), None, res_da)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("with_da", [False, True])
def test_route_with_lakes_on_card_equals_the_plain_level_pool(
        cuda, dtype, with_da, monkeypatch):
    """12 short steps of a 20,000-segment CONUS-like network with 200 lakes
    on the card, with the level-pool kernel and with the engine's lake
    block as it was before the kernel (``quc[res_rows]``, the plain
    ``levelpool_step`` with zero lateral inflow, with DA the plain
    ``typed_reservoir_dispatch``, out-of-place ``index_put`` of the
    outflow and depth): the same arrays, bit for bit.  One launch of the
    kernel a step (its DA form with DA), counted by the wrapper and, under
    a profiler, by ``engine.levelpool_launches``."""
    from torch.profiler import ProfilerActivity, profile

    from troute_torch import tracing
    from troute_torch.ops import levelpool_cuda
    from troute_torch.ops.levelpool import levelpool_step
    nts = 12
    case = _lake_route_case(20_000, 200, seed=21)
    tracing.drain()
    before = levelpool_cuda.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]):
        got = _lake_route(case, dtype, cuda, nts, with_da)
        torch.cuda.synchronize()
    assert levelpool_cuda.LAUNCHES - before == nts
    assert tracing.drain()[1]["engine.levelpool_launches"] == nts

    def plain_rows(H, quc, rows, dt, p, into=None):
        inflow = quc[rows]
        out, h_new = levelpool_step(H, inflow, inflow,
                                    torch.zeros_like(inflow), dt, p)
        if into is None:
            return out, h_new, inflow
        for a, v in zip(into, (out, h_new)):
            a.copy_(a.index_put((rows,), v))
        return h_new

    def plain_da_rows(H, quc, rows, dt, p, res_da, states, now, month_i, *,
                      into):
        lp_out, lp_elev, inflow = plain_rows(H, quc, rows, dt, p)
        out, elev, d_scat, *states = plain_dispatch(
            res_da, states, H, inflow, lp_out, lp_elev, now, month_i, p, dt)
        for a, v in zip(into, (out, d_scat)):
            a.copy_(a.index_put((rows,), v))
        return elev, tuple(states)

    monkeypatch.setattr(engine, "levelpool_rows_cuda", plain_rows)
    monkeypatch.setattr(engine, "levelpool_da_rows_cuda", plain_da_rows)
    want = _lake_route(case, dtype, cuda, nts, with_da)
    torch.cuda.synchronize()
    assert levelpool_cuda.LAUNCHES - before == nts
    assert torch.equal(got["flowveldepth"], want["flowveldepth"])
    for f in ("q", "depth", "res_elev"):
        assert torch.equal(getattr(got["state"], f),
                           getattr(want["state"], f)), f
    if with_da:
        for a, b in zip(got["state"].hybrid, want["state"].hybrid):
            assert torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0))

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``troute_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

1. Device: the card's name and power limit, the torch/CUDA/nvcc versions,
   and the build of the MC kernel (``troute_torch/csrc/mc_secant.cu``) from
   this checkout.
2. Kernel against plain: the kernel and the plain ``solve_block`` on the
   same card, on the CONUS parameter ranges of ``tests/test_muskingum.py``
   (2,729,077 lanes f32, 1,000,000 f64), the golden values and zero
   forcing, at the tests' tolerances; kernel and plain times in ms.
3. Engine, card against CPU: ``route_stepped`` on a 200,000-segment
   synthetic network with level-pool reservoirs and gages, 24 steps, on
   the card (kernel) and on the CPU (plain), in f64 (``check_f64_network``)
   and f32 (the f32 bar).
4. Main path at CONUS scale: ``bench.py``'s headline setup (2,729,077
   segments, dt 300 s, 24 steps per window, qts 12, f32) through the
   port's ``route_stepped`` on the card, cold and warm windows, with the
   kernel's launches counted; then the kernel and the plain version on
   one warm step's inputs.
5. Kernel B2 against plain: the block-skip kernel and the plain
   ``solve_block_skip`` on the card, on the CONUS ranges (2,729,077 f32
   lanes bit for bit, 1,000,000 f64 lanes at rtol 1e-9), for four
   activity patterns; active blocks equal B1, inactive blocks ``prev``;
   B2, plain and B1 ms per pattern (f32).
6. Strict engine, card against CPU: ``route_stepped``'s strict fixed-point
   mode (accelerator "auto", block skip on) on a 50,000-segment network
   with 50 reservoirs and 100 gages, 6 steps from a warm state, f64 (rtol
   1e-9, atol 1e-8) and f32 (the f32 bar, at most 1e-3 of the values past
   rtol/atol 1e-4); the card's B1/B2 launches equal the driver's own MC
   call counts.
7. Strict path at CONUS scale: ``bench.py:482-515`` and
   ``benchmarks/bench_strict_skip.py`` on the port, from phase 4's warm
   state: 12-step strict windows (qts 2, f32) with ``strict_block_skip``
   off and on (accelerator "auto"), and with the accelerator off, one
   warm-up window each, then 4 interleaved timed turns, with launches
   counted; one profiled window of each for the device's idle share; then
   B2 and the plain version on one real skip sweep's inputs, captured from
   a further window.

Every check raises on failure, so the script exits non-zero.  It exits 1,
printing no result, when no CUDA device is visible or it is not run from a
checkout.  The line before last is a JSON object with the kernels'
measurements; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NAMES = ("qup", "quc", "qdp", "ql", "dx", "bw", "tw", "twcc", "n", "ncc",
         "cs", "s0", "depthp")
DT = 300.0
N_CONUS = 2_729_077

# golden inputs and outputs of the reference demo (tests/test_muskingum.py)
GOLDEN = dict(qup=0.04598825, quc=0.04598825, qdp=0.21487340, ql=40.0,
              dx=1800.0, bw=112.0, tw=448.0, twcc=623.5999755859375,
              n=0.02800000086426735, ncc=0.03136000037193298,
              cs=1.399999976158142, s0=0.0017999999690800905,
              depthp=0.0100334705)
GOLDEN_F32 = (0.7570106983184814, 0.12373604625463486, 0.02334451675415039)
GOLDEN64_IN = dict(GOLDEN, qup=0.04598825885217007, quc=0.04598825885217007,
                   qdp=0.21487345087737053, depthp=0.010033471026476835)
GOLDEN_F64 = (0.7570107902354513, 0.12373606306742324, 0.02334451646521419)
GOLDEN_DT = 60.0


def log(msg: str) -> None:
    print(msg, flush=True)


def conus_range_inputs(n: int, seed: int) -> list[np.ndarray]:
    """CONUS NWM parameter ranges (tests/test_muskingum.py:69-86)."""
    rng = np.random.default_rng(seed)
    p = dict(dx=rng.uniform(1.0, 95714.0, n), bw=rng.uniform(0.135, 230.0, n),
             tw=rng.uniform(0.225, 383.392, n),
             twcc=rng.uniform(0.674, 1150.175, n),
             n=rng.uniform(0.04, 0.06, n), ncc=rng.uniform(0.08, 0.12, n),
             cs=rng.uniform(0.0846, 2.254, n),
             s0=rng.uniform(0.00001, 4.6, n), ql=rng.uniform(1.0, 70000.0, n),
             qup=rng.uniform(1.0, 70000.0, n),
             quc=rng.uniform(1.0, 70000.0, n),
             qdp=rng.uniform(1.0, 70000.0, n),
             depthp=rng.uniform(1.0, 25.0, n))
    return [p[k] for k in NAMES]


def rel_diff(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-6)


def check_f32_bar(got, want, what: str, max_share=None) -> dict:
    """The f32 bar: rel diff median <= 1e-6, p95 <= 1e-5, max <= 5e-2; with
    ``max_share``, lanes past 5e-2 are bounded as a share instead (secant
    path flips on the extreme CONUS-range tail, as in the CPU tests)."""
    rel = rel_diff(got, want)
    st = dict(median=float(np.median(rel)),
              p95=float(np.percentile(rel, 95)), max=float(rel.max()),
              over_5e_2=int((rel > 5e-2).sum()))
    ok = st["median"] <= 1e-6 and st["p95"] <= 1e-5 and (
        st["max"] <= 5e-2 if max_share is None
        else st["over_5e_2"] <= max_share * rel.size)
    if not ok:
        raise AssertionError(f"{what}: f32 bar not met {st}")
    return st


def check_f64(got_list, want_list, what: str, inputs=None) -> int:
    """rtol 1e-9, atol 1e-12 per lane.  With ``inputs`` (MC lanes), a lane
    off that bar is settled by the scalar oracle: the kernel must be at
    least as close to it as the plain version (at most 0.5% of lanes)."""
    off = np.zeros(got_list[0].shape, bool)
    for g, w in zip(got_list, want_list):
        off |= ~np.isclose(g, w, rtol=1e-9, atol=1e-12)
    lanes = np.flatnonzero(off)
    if lanes.size and inputs is None:
        raise AssertionError(f"{what}: {lanes.size} values off rtol 1e-9, "
                             f"first at {lanes[:5]}")
    if lanes.size > max(1, off.size // 200):
        raise AssertionError(f"{what}: {lanes.size} lanes off rtol 1e-9")
    if lanes.size:
        from reference_impl import muskingum_cunge_ref
        for i in lanes:
            ref = muskingum_cunge_ref(DT, *[a[i] for a in inputs],
                                      dtype=np.float64)
            for k, (g, w) in enumerate(zip(got_list, want_list)):
                if abs(g[i] - ref[k]) > max(abs(w[i] - ref[k]),
                                            1e-9 * abs(ref[k]) + 1e-12):
                    raise AssertionError(f"{what}: lane {i} output {k}")
    return int(lanes.size)


def cuda_ms(fn, reps: int = 5, warm_up: bool = True) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` calls back to back
    between two CUDA events, over ``reps``, after one warm-up call unless
    ``warm_up`` is False.  Back to back, the host enqueues the next call
    while the card runs this one, so a wrapper's host time shows only
    where it exceeds the device time."""
    import torch
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_device(device) -> str:
    import torch
    from troute_torch import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {nvcc}")
    log(f"device {device}: {torch.cuda.get_device_name(device)}")
    t0 = time.perf_counter()
    lib, _ = _build.build("mc_secant")
    _build.load("mc_secant")
    log(f"phase 1: built {lib.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.2f} s")
    return smi


def phase_kernel_vs_plain(device, n32: int, n64: int) -> None:
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.muskingum import solve_block

    def on_card(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    for dtype, inp, want, rel in (
            (torch.float32, GOLDEN, GOLDEN_F32, 2e-5),
            (torch.float64, GOLDEN64_IN, GOLDEN_F64, 1e-7)):
        out = mcc.muskingum_cunge_cuda(
            *[on_card([inp[k]], dtype) for k in NAMES], GOLDEN_DT)
        torch.cuda.synchronize()
        for k in range(3):
            got = float(out[k][0])
            if abs(got - want[k]) > rel * abs(want[k]):
                raise AssertionError(f"golden {dtype} output {k}: {got} vs "
                                     f"{want[k]}")
        z = torch.zeros(4, dtype=dtype, device=device)
        one = torch.ones(4, dtype=dtype, device=device)
        out = mcc.muskingum_cunge_cuda(
            z, z, z, z, 1800.0 * one, 112.0 * one, 448.0 * one, 623.6 * one,
            0.028 * one, 0.031 * one, 1.4 * one, 0.0018 * one, z, DT)
        torch.cuda.synchronize()
        for o in (out.qdc, out.velc, out.depthc, out.X):
            if bool((o != 0).any()):
                raise AssertionError("zero forcing gave a nonzero output")
    log("phase 2: golden values and zero forcing pass (f32, f64)")

    for dtype, n in ((torch.float32, n32), (torch.float64, n64)):
        inputs = conus_range_inputs(n, seed=0)
        args = [on_card(a, dtype) for a in inputs]
        k_out = mcc.muskingum_cunge_cuda(*args, DT)
        torch.cuda.synchronize()
        p_out = solve_block(*args, dt=DT)
        torch.cuda.synchronize()
        got = [o.cpu().numpy() for o in k_out]
        want = [o.cpu().numpy() for o in p_out]
        max_abs = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
        if dtype == torch.float32:
            stats = [check_f32_bar(g, w, f"conus-range f32 output {k}",
                                   max_share=0.005)
                     for k, (g, w) in enumerate(zip(got, want))]
            worst = max(s["max"] for s in stats)
            log(f"phase 2: kernel vs plain f32, {n} lanes, 6 outputs: "
                f"median/p95/max rel {max(s['median'] for s in stats):.3g}/"
                f"{max(s['p95'] for s in stats):.3g}/{worst:.3g}, lanes "
                f"past 5e-2: {max(s['over_5e_2'] for s in stats)}, max abs "
                f"{max_abs:.3g}")
            k_ms = cuda_ms(lambda: mcc.muskingum_cunge_cuda(*args, DT))
            p_ms = cuda_ms(lambda: solve_block(*args, dt=DT))
            log(f"phase 2: conus-range f32 {n} lanes: kernel {k_ms:.3f} ms, "
                f"plain {p_ms:.3f} ms")
        else:
            n_off = check_f64(got, want, "conus-range f64", inputs=inputs)
            log(f"phase 2: kernel vs plain f64, {n} lanes, 6 outputs: rtol "
                f"1e-9 holds on all but {n_off} lanes (settled by the "
                f"scalar oracle), max abs {max_abs:.3g}")
        del args, k_out, p_out


def _network(n: int, n_res: int, n_gage: int, seed: int):
    """Post-order synthetic CONUS-statistics network with level-pool
    reservoirs and gages, as NumPy inputs for ``route_stepped``."""
    import bench
    from troute_torch.network.topology import build_topology_postorder
    ids, down = bench.synthetic_conus(n=n)
    rng = np.random.default_rng(seed)
    has_up = np.zeros(n, bool)
    has_up[np.searchsorted(ids, down[down > 0])] = True
    nt = np.zeros(n, np.int8)
    nt[rng.choice(np.flatnonzero(has_up), n_res, replace=False)] = 1
    topo = build_topology_postorder(ids, down, node_type=nt)
    chan = bench.channel_params(n, rng)
    lp = [rng.uniform(1.0, 3.0, n_res)] + [np.full(n_res, v) for v in (
        12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 10.0)]
    q0 = rng.uniform(0.5, 5.0, n)
    d0 = rng.uniform(0.05, 0.8, n)
    elev0 = rng.uniform(10.0, 11.5, n_res)
    d0[topo.reservoir_rows] = elev0
    qlat = rng.uniform(0.1, 2.0, (2, n))
    obs = rng.uniform(1.0, 10.0, (25, n_gage))
    obs[rng.random(obs.shape) < 0.4] = np.nan
    gage = dict(rows=rng.choice(np.flatnonzero(topo.node_type == 0), n_gage,
                                replace=False),
                obs=obs, lastobs_val=rng.uniform(1, 10, n_gage),
                lastobs_time=-rng.uniform(0, 3600, n_gage))
    return topo, chan, lp, q0, d0, elev0, qlat, gage


def _route(device, dtype, case, nts: int, qts: int = 12,
           strict: bool = False, start: dict | None = None,
           collect: bool = True):
    """``route_stepped`` on ``case`` from its initial state, or from the
    tensors of ``start`` (q, depth, res_elev, lastobs_val, lastobs_time,
    copied to ``device``): short steps, or strict fixed-point steps with
    the block skip on."""
    import torch
    from troute_torch.ops.levelpool import LevelpoolParams
    from troute_torch.routing import engine
    topo, chan, lp, q0, d0, elev0, qlat, gage = case

    def t(a, dt=dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dt)
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    s = dict(q=q0, depth=d0, res_elev=elev0,
             lastobs_val=gage["lastobs_val"],
             lastobs_time=gage["lastobs_time"])
    s.update(start or {})
    net = engine.network_arrays_from_topology(topo, device=device)
    da = engine.GageDA(rows=t(gage["rows"], torch.int64), obs=t(gage["obs"]),
                       lastobs_val=t(s["lastobs_val"]),
                       lastobs_time=t(s["lastobs_time"]), decay_coeff=120.0)
    cfg = engine.RoutingConfig(
        dt=DT, nts=nts, qts_subdivisions=qts, assume_short_ts=not strict,
        strict_iterative=strict, strict_block_skip=strict)
    out = engine.route_stepped(
        net, engine.ChannelParams.from_arrays(device=device, dtype=dtype,
                                              **chan),
        LevelpoolParams(*[t(v) for v in lp]), cfg, t(s["q"]), t(s["depth"]),
        t(s["res_elev"]), t(qlat), da, collect=collect)
    if device != "cpu":
        torch.cuda.synchronize()
    st = out["state"]
    res = {"fvd": out["flowveldepth"], "nudge": out["nudge"], "q": st.q,
           "depth": st.depth, "res_elev": st.res_elev,
           "lastobs_val": st.lastobs_val, "lastobs_time": st.lastobs_time,
           "state": st}
    if strict:
        res.update(strict_sweeps=out["strict_sweeps"],
                   strict_mc_calls=out["strict_mc_calls"])
    return res


def check_f64_network(got, want, what: str, atol: float = 1e-12) -> dict:
    """f64 bar for a multi-step network run, over all its output values:
    rtol 1e-9 (with ``atol``) on all but 1e-5 of them, and rel diff <=
    1e-6 or abs diff <= ``atol`` everywhere.  A few segments amplify a
    last-ulp difference of ``pow`` by ~1e4 per step through the secant's
    dependence on its starting depth; two CPU implementations (JAX's and
    the port's, different libm ``pow``) differ the same way on this
    network: 42 of 14.4M values past 1e-9, max rel 3.6e-7."""
    ok = ~np.isnan(want)
    if not np.array_equal(np.isnan(got), ~ok):
        raise AssertionError(f"{what}: NaN pattern differs")
    diff = np.abs(got[ok] - want[ok])
    rel = np.where(diff <= atol, 0.0, rel_diff(got[ok], want[ok]))
    off = ~np.isclose(got[ok], want[ok], rtol=1e-9, atol=atol)
    st = dict(off=int(off.sum()), n=int(ok.sum()),
              max=float(rel.max()) if rel.size else 0.0)
    if st["off"] > 1e-5 * st["n"] or st["max"] > 1e-6:
        raise AssertionError(f"{what}: f64 bar not met {st}")
    return st


def phase_engine_card_vs_cpu(device, n: int, nts: int) -> None:
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    case = _network(n, n_res=max(n // 1000, 1), n_gage=max(n // 500, 1),
                    seed=5)
    for dtype in (torch.float64, torch.float32):
        before = mcc.LAUNCHES
        t0 = time.perf_counter()
        card = _route(device, dtype, case, nts)
        t_card = time.perf_counter() - t0
        if mcc.LAUNCHES - before != nts:
            raise AssertionError("the card run did not launch the kernel "
                                 "once per step")
        t0 = time.perf_counter()
        cpu = _route("cpu", dtype, case, nts)
        t_cpu = time.perf_counter() - t0
        # every output value of the run (fvd, nudge, final state) as one
        # vector
        keys = ("fvd", "nudge", "q", "depth", "res_elev", "lastobs_val",
                "lastobs_time")
        got = np.concatenate([card[k].cpu().numpy().ravel() for k in keys])
        want = np.concatenate([cpu[k].numpy().ravel() for k in keys])
        if not np.isfinite(got[~np.isnan(want)]).all():
            raise AssertionError("non-finite output on the card")
        if dtype == torch.float64:
            st = check_f64_network(got, want, "engine f64")
            bar = f"rtol 1e-9 off at {st['off']} of {st['n']} values"
        else:
            # f32 secant path flips compound downstream over the steps, so
            # values past 5e-2 are bounded as a share (1e-5) of the run
            ok = ~np.isnan(want)
            st = check_f32_bar(got[ok], want[ok], "engine f32",
                               max_share=1e-5)
            bar = (f"f32 bar: median {st['median']:.3g}, p95 "
                   f"{st['p95']:.3g}, {st['over_5e_2']} of {ok.sum()} "
                   f"values past 5e-2")
        rel = np.where(np.isnan(want), 0.0, rel_diff(got, want))
        i, start = int(np.argmax(rel)), 0
        for k in keys:
            size = card[k].numel()
            if i < start + size:
                where = (k, [int(x) for x in np.unravel_index(
                    i - start, tuple(card[k].shape))])
                break
            start += size
        log(f"phase 3: route_stepped {dtype} n={n} nts={nts}, card vs cpu "
            f"max rel {st['max']:.3g} at {where[0]}{where[1]} "
            f"(card {got[i]:.9g}, cpu {want[i]:.9g}; {bar}); card "
            f"{t_card:.2f} s, cpu {t_cpu:.2f} s")


def phase_main_path(device, n: int, nts: int, smi: str) -> dict:
    """bench.py:410-480 on the port: cold windows re-route the initial
    state, warm windows hand the state forward with fresh forcing."""
    import torch
    import bench
    from troute_torch.network.topology import build_topology
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.levelpool import LevelpoolParams
    from troute_torch.ops.muskingum import solve_block
    from troute_torch.routing import engine

    f32 = torch.float32
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    ids, down = bench.synthetic_conus(n)
    topo = build_topology(ids, down)
    net = engine.network_arrays_from_topology(topo, device=device)
    chan = bench.channel_params(n, rng)
    cp = engine.ChannelParams.from_arrays(device=device, dtype=f32, **chan)
    lp = LevelpoolParams(*[torch.ones(1, dtype=f32, device=device)] * 9)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    q0 = t(rng.uniform(0.5, 5.0, n))
    d0 = t(rng.uniform(0.05, 0.8, n))
    qlats = [t(rng.uniform(0.1, 2.0, (2, n))) for _ in range(4)]
    zeros1 = torch.zeros(1, dtype=f32, device=device)
    cfg = engine.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=nts // 2,
                               assume_short_ts=True, kernel="pallas")
    log(f"phase 4: setup {time.perf_counter() - t0:.1f} s (N={n}, "
        f"n_pad={net.uplan.n_pad}, shifts={len(net.uplan.shifts)}, "
        f"remainder={int(net.uplan.rem_dst.shape[0])})")

    def window(q, d, qlat):
        t0 = time.perf_counter()
        out = engine.route_stepped(net, cp, lp, cfg, q, d, zeros1, qlat)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for v in (out["flowveldepth"], out["state"].q, out["state"].depth):
            if not bool(torch.isfinite(v).all()):
                raise AssertionError("non-finite output on the main path")
        return out, dt

    torch.cuda.reset_peak_memory_stats(device)
    mcc.LAUNCHES = 0
    out, first_s = window(q0, d0, qlats[0])
    cold = [window(q0, d0, qlats[0])[1] for _ in range(5)]
    q_w, d_w = out["state"].q, out["state"].depth
    warm = []
    for i in range(13):
        out, dt = window(q_w, d_w, qlats[(i + 1) % len(qlats)])
        q_w, d_w = out["state"].q, out["state"].depth
        if i >= 3:
            warm.append(dt)
    launches = mcc.LAUNCHES
    windows = 1 + len(cold) + 13
    if launches != windows * nts:
        raise AssertionError(f"{launches} kernel launches for {windows} "
                             f"windows of {nts} steps")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    seg = n * nts
    log(f"phase 4: {launches} kernel launches = {nts} per window x "
        f"{windows} windows; all outputs finite; peak {peak_gb:.2f} GB")
    log(f"phase 4: first window {first_s:.3f} s; cold best "
        f"{min(cold):.4f} s median {statistics.median(cold):.4f} s -> "
        f"{seg / min(cold):.4e} seg-ts/s; warm best {min(warm):.4f} s "
        f"median {statistics.median(warm):.4f} s -> "
        f"{seg / min(warm):.4e} seg-ts/s  [{smi}]")

    # one warm step's kernel inputs, as _one_short_step builds them
    pad = net.uplan.n_pad - n
    padz = torch.zeros(pad, dtype=f32, device=device)
    q = torch.cat([q_w, padz])
    args = [engine._upstream_sum_stepped(q, net.upstream, net.uplan)] * 2 \
        + [q, torch.cat([qlats[0][0], padz])] \
        + [torch.cat([c, padz + 1.0]) for c in cp] \
        + [torch.cat([d_w, padz])]
    args = [a.contiguous() for a in args]
    k_out = mcc.muskingum_cunge_cuda(*args, DT, with_diagnostics=False)
    torch.cuda.synchronize()
    p_out = solve_block(*args, dt=DT)
    torch.cuda.synchronize()
    max_abs = 0.0
    for k in range(3):
        got, want = k_out[k].cpu().numpy(), p_out[k].cpu().numpy()
        check_f32_bar(got, want, f"warm-step output {k}")
        max_abs = max(max_abs, float(np.abs(got - want).max()))
    k_ms = cuda_ms(lambda: mcc.muskingum_cunge_cuda(
        *args, DT, with_diagnostics=False))
    p_ms = cuda_ms(lambda: solve_block(*args, dt=DT))
    up_ms = cuda_ms(lambda: net.uplan(q))
    log(f"phase 4: warm step, {net.uplan.n_pad} lanes f32: kernel "
        f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, max abs diff {max_abs:.3g}; "
        f"banded upstream sum {up_ms:.3f} ms  [{smi}]")
    return dict(launches=launches, max_abs=max_abs, ms=k_ms, plain_ms=p_ms,
                setup=dict(net=net, cp=cp, lp=lp, qlats=qlats, q=q_w, d=d_w))


def _skip_vs_plain(args, active, prev, full, what: str, inputs=None):
    """B2 on ``args`` against ``solve_block_skip`` on the same card: f32 bit
    for bit, f64 at rtol 1e-9 (``check_f64``); solved lanes equal B1's
    ``full`` and passed-through lanes ``prev``, exactly.  Returns the
    share of active blocks and the max abs difference."""
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.muskingum import solve_block_skip
    n_out = 3 if full is None else 6
    got = mcc.muskingum_cunge_cuda(*args, DT, with_diagnostics=n_out == 6,
                                   active_rows=active, prev=prev)
    ran = mcc.block_active_lanes(active)
    want = solve_block_skip(*args, dt=DT, ran=ran, prev=prev)
    torch.cuda.synchronize()
    got = [o.cpu().numpy() for o in got[:n_out]]
    want = [o.cpu().numpy() for o in want[:n_out]]
    ran = ran.cpu().numpy()
    if args[0].dtype == torch.float32:
        for k, (g, w) in enumerate(zip(got, want)):
            if not np.array_equal(g, w):
                raise AssertionError(f"{what}: output {k} not bit for bit")
    else:
        check_f64(got, want, what, inputs=inputs)
    for k in range(n_out):
        if full is not None and not np.array_equal(
                got[k][ran], full[k].cpu().numpy()[ran]):
            raise AssertionError(f"{what}: a solved block differs from B1")
        if not np.array_equal(got[k][~ran], prev[k].cpu().numpy()[~ran]):
            raise AssertionError(f"{what}: a skipped block is not prev")
    max_abs = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    blocks = mcc.block_flags(active).float().mean().item()
    return blocks, max_abs


def phase_skip_vs_plain(device, n32: int, n64: int) -> None:
    """Kernel B2 against its plain version on the CONUS ranges, for four
    activity patterns."""
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.muskingum import MCOutput, solve_block_skip

    for dtype, n in ((torch.float32, n32), (torch.float64, n64)):
        inputs = conus_range_inputs(n, seed=0)
        args = [torch.as_tensor(a, dtype=dtype, device=device)
                for a in inputs]
        full = mcc.muskingum_cunge_cuda(*args, DT)
        # distinct from the solution in every output, in output order
        prev = MCOutput(*[o + 7.0 + k for k, o in enumerate(full)])
        lane = torch.arange(n, device=device)
        rng = np.random.default_rng(3)
        patterns = {
            "none active": torch.zeros(n, dtype=torch.bool, device=device),
            "all active": torch.ones(n, dtype=torch.bool, device=device),
            "every other block": (lane // mcc.SKIP_BLOCK) % 2 == 0,
            "10% of lanes moved": torch.as_tensor(rng.random(n) < 0.1,
                                                  device=device)}
        b1_ms = (cuda_ms(lambda: mcc.muskingum_cunge_cuda(*args, DT))
                 if dtype == torch.float32 else None)
        for name, act in patterns.items():
            blocks, max_abs = _skip_vs_plain(
                args, act, prev, full, f"B2 {dtype} {name}", inputs)
            line = (f"phase 5: B2 vs plain {dtype}, {n} lanes, {name} "
                    f"({blocks:.4f} of blocks active): "
                    + ("bit for bit" if dtype == torch.float32 else
                       "rtol 1e-9") + f", max abs {max_abs:.3g}")
            if dtype == torch.float32:
                ran = mcc.block_active_lanes(act)
                b2_ms = cuda_ms(lambda: mcc.muskingum_cunge_cuda(
                    *args, DT, active_rows=act, prev=prev))
                # the plain version solves every lane whatever the flags;
                # its correctness call above was its warm-up
                p_ms = cuda_ms(lambda: solve_block_skip(
                    *args, dt=DT, ran=ran, prev=prev), reps=1, warm_up=False)
                line += (f"; B2 {b2_ms:.3f} ms, plain {p_ms:.3f} ms, "
                         f"B1 {b1_ms:.3f} ms")
            log(line)
        del args, full, prev, patterns


def _warm_state(device, dtype, case, nts: int = 12):
    """The state after ``nts`` short steps on ``device``: a routed start
    for the strict runs, as production strict windows have."""
    return _route(device, dtype, case, nts, qts=6, collect=False)["state"]


def phase_strict_card_vs_cpu(device, n: int, nts: int) -> None:
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    case = _network(n, n_res=n // 1000, n_gage=n // 500, seed=5)
    for dtype in (torch.float64, torch.float32):
        st = _warm_state(device, dtype, case)
        start = dict(q=st.q, depth=st.depth, res_elev=st.res_elev,
                     lastobs_val=st.lastobs_val,
                     lastobs_time=st.lastobs_time)
        strict = dict(nts=nts, qts=3, strict=True, start=start)
        mcc.LAUNCHES = mcc.SKIP_LAUNCHES = 0
        t0 = time.perf_counter()
        card = _route(device, dtype, case, **strict)
        t_card = time.perf_counter() - t0
        calls = card["strict_mc_calls"]
        launched = {"mc_secant": mcc.LAUNCHES,
                    "mc_secant_skip": mcc.SKIP_LAUNCHES}
        if launched != calls or not calls["mc_secant_skip"]:
            raise AssertionError(f"strict card run launched {launched}, its "
                                 f"sweeps call for {calls}")
        t0 = time.perf_counter()
        cpu = _route("cpu", dtype, case, **strict)
        t_cpu = time.perf_counter() - t0
        keys = ("fvd", "nudge", "q", "depth", "res_elev", "lastobs_val",
                "lastobs_time")
        got = np.concatenate([card[k].cpu().numpy().ravel() for k in keys])
        want = np.concatenate([cpu[k].numpy().ravel() for k in keys])
        if not np.isfinite(got[~np.isnan(want)]).all():
            raise AssertionError("non-finite strict output on the card")
        if dtype == torch.float64:
            # a chunk boundary that falls on the other side of the
            # tolerance moves the committed iterate by O(strict_tol)
            st = check_f64_network(got, want, "strict f64", atol=1e-8)
            bar = (f"rtol 1e-9 / atol 1e-8 (10 strict_tol) off at "
                   f"{st['off']} of {st['n']} values, max rel {st['max']:.3g}")
        else:
            # the f32 secant stops on a relative step, so a last-ulp
            # difference can change a lane's trip count and move the
            # strict fixed point past rtol/atol 1e-4 on a few values; on
            # the CPU alone, a 2-ulp nudge of this warm start does so on
            # 166 of 900,000 values (max rel 1.3e-2).  So: the f32 bar,
            # and at most 1e-3 of the values past rtol/atol 1e-4
            ok = ~np.isnan(want)
            st = check_f32_bar(got[ok], want[ok], "strict f32",
                               max_share=1e-5)
            off = int((~np.isclose(got[ok], want[ok], rtol=1e-4,
                                   atol=1e-4)).sum())
            if off > 1e-3 * ok.sum():
                raise AssertionError(f"strict f32: {off} values past "
                                     f"rtol/atol 1e-4")
            bar = (f"f32 bar: median {st['median']:.3g}, p95 "
                   f"{st['p95']:.3g}, max {st['max']:.3g}; {off} of "
                   f"{ok.sum()} values past rtol/atol 1e-4, max abs "
                   f"{float(np.abs(got[ok] - want[ok]).max()):.3g}")
        log(f"phase 6: strict route_stepped {dtype} n={n} nts={nts}, card vs "
            f"cpu: {bar}; sweeps card {card['strict_sweeps']} cpu "
            f"{cpu['strict_sweeps']}; launches {launched}; card "
            f"{t_card:.2f} s, cpu {t_cpu:.2f} s")


def profile_window(fn) -> dict:
    """Device busy time of one call of ``fn`` under ``torch.profiler``: the
    union of the kernel, memcpy and memset intervals of its trace, and the
    kernels that take most of it.  Busy ms is None when the profiler saw no
    device activity (it then measured nothing)."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            name = e.get("name", "?")[:60]
            by_name[name] = by_name.get(name, 0.0) + float(e["dur"])
    if not spans:
        return dict(busy_ms=None, launches=0, top=[])
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(busy_ms=busy / 1e3, launches=len(spans),
                top=[(k, round(v / 1e3, 3)) for k, v in top])


def phase_strict_main_path(device, ctx: dict, smi: str) -> dict:
    """bench.py:482-515 and benchmarks/bench_strict_skip.py on the port:
    12-step strict windows from phase 4's warm state, block skip off and
    on (accelerator "auto", on), and the plain Jacobi sweeps (accelerator
    off) beside them, in interleaved turns, the state handed forward."""
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.muskingum import solve_block_skip
    from troute_torch.routing import engine

    nts, n = 12, int(ctx["q"].shape[0])
    zeros1 = torch.zeros(1, dtype=torch.float32, device=device)
    cfgs = {name: engine.RoutingConfig(
                dt=DT, nts=nts, qts_subdivisions=2, assume_short_ts=False,
                strict_iterative=True, strict_block_skip=skip,
                strict_accel=accel)
            for name, skip, accel in (("skip off", False, "auto"),
                                      ("skip on", True, "auto"),
                                      ("accel off", False, False))}
    calls = {"mc_secant": 0, "mc_secant_skip": 0}
    state = [ctx["q"], ctx["d"]]

    def window(name, qlat):
        t0 = time.perf_counter()
        out = engine.route_stepped(ctx["net"], ctx["cp"], ctx["lp"],
                                   cfgs[name], *state, zeros1, qlat)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for v in (out["flowveldepth"], out["state"].q, out["state"].depth):
            if not bool(torch.isfinite(v).all()):
                raise AssertionError("non-finite output on the strict path")
        for k in calls:
            calls[k] += out["strict_mc_calls"][k]
        state[:] = [out["state"].q, out["state"].depth]
        return dt, out["strict_sweeps"]

    torch.cuda.reset_peak_memory_stats(device)
    mcc.LAUNCHES = mcc.SKIP_LAUNCHES = 0
    first = {name: window(name, ctx["qlats"][0])[0] for name in cfgs}
    times = {name: [] for name in cfgs}
    sweeps = {name: [] for name in cfgs}
    for i in range(4):
        for name in cfgs:
            dt, sw = window(name, ctx["qlats"][i % 4])
            times[name].append(dt)
            sweeps[name] += sw
    launched = {"mc_secant": mcc.LAUNCHES, "mc_secant_skip": mcc.SKIP_LAUNCHES}
    if launched != calls or not all(launched.values()):
        raise AssertionError(f"strict path launched {launched}, its sweeps "
                             f"call for {calls}")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    log(f"phase 7: strict windows ({nts} steps, f32, N={n}): launches "
        f"{launched} = the driver's MC calls; all outputs finite; peak "
        f"{peak_gb:.2f} GB; warm-up windows "
        + ", ".join(f"{t:.3f} s ({name})" for name, t in first.items()))
    for name, ts in times.items():
        log(f"phase 7: {name}: best {min(ts):.4f} s median "
            f"{statistics.median(ts):.4f} s -> {n * nts / min(ts):.4e} "
            f"seg-ts/s (median {n * nts / statistics.median(ts):.4e}); "
            f"sweeps per step {statistics.mean(sweeps[name]):.2f} "
            f"{sweeps[name]}; all {[round(t, 4) for t in ts]}  [{smi}]")

    # the device's idle share: busy time of one profiled window against
    # the median unprofiled window (the profiler inflates the host side)
    for name in cfgs:
        prof = profile_window(lambda: window(name, ctx["qlats"][1]))
        wall_ms = 1e3 * statistics.median(times[name])
        idle = ("not measured (the profiler saw no device activity)"
                if prof["busy_ms"] is None else
                f"device busy {prof['busy_ms']:.3f} ms of the median "
                f"unprofiled {wall_ms:.3f} ms -> idle share "
                f"{1.0 - prof['busy_ms'] / wall_ms:.3f}")
        log(f"phase 7: profile {name}: {idle}; {prof['launches']} device "
            f"ops; top {prof['top']}  [{smi}]")

    # one real skip sweep: the skip call of one more window whose share
    # of active blocks is nearest one half
    real, best = engine.muskingum_cunge_cuda, {}

    def capture(*args, **kw):
        out = real(*args, **kw)
        if kw.get("active_rows") is not None:
            share = mcc.block_flags(kw["active_rows"]).float().mean().item()
            if not best or abs(share - 0.5) < abs(best["share"] - 0.5):
                best.update(share=share, args=args, kw=kw)
        return out

    engine.muskingum_cunge_cuda = capture
    try:
        window("skip on", ctx["qlats"][0])
    finally:
        engine.muskingum_cunge_cuda = real
    if not best:
        raise AssertionError("the strict window made no skip sweep")
    args, kw = best["args"][:13], best["kw"]
    diag = kw["with_diagnostics"]
    full = mcc.muskingum_cunge_cuda(*args, DT, with_diagnostics=diag)
    blocks, max_abs = _skip_vs_plain(args, kw["active_rows"], kw["prev"],
                                     full if diag else None,
                                     "captured skip sweep")
    ran = mcc.block_active_lanes(kw["active_rows"])
    b2_ms = cuda_ms(lambda: mcc.muskingum_cunge_cuda(*args, DT, **kw),
                    reps=20)
    p_ms = cuda_ms(lambda: solve_block_skip(*args, dt=DT, ran=ran,
                                            prev=kw["prev"]))
    b1_ms = cuda_ms(lambda: mcc.muskingum_cunge_cuda(
        *args, DT, with_diagnostics=diag), reps=20)
    log(f"phase 7: one skip sweep, {args[0].shape[0]} lanes f32, "
        f"{blocks:.4f} of blocks active: B2 {b2_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms, B1 {b1_ms:.3f} ms; bit for bit (max abs "
        f"{max_abs:.3g})  [{smi}]")
    return dict(launches=launched, max_abs=max_abs, ms=b2_ms, plain_ms=p_ms)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not (ROOT / "troute_torch" / "csrc" / "mc_secant.cu").is_file():
        print("chip_smoke: run from the root of a troute checkout",
              file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    device = "cuda:0"
    torch.cuda.set_device(device)
    t_start = time.perf_counter()
    smi = phase_device(device)
    phase_kernel_vs_plain(device, n32=N_CONUS, n64=1_000_000)
    phase_engine_card_vs_cpu(device, n=200_000, nts=24)
    m = phase_main_path(device, n=N_CONUS, nts=24, smi=smi)
    phase_skip_vs_plain(device, n32=N_CONUS, n64=1_000_000)
    phase_strict_card_vs_cpu(device, n=50_000, nts=6)
    s = phase_strict_main_path(device, m["setup"], smi)
    if "jax" in sys.modules:
        raise AssertionError("the port's run imported JAX")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    src = "troute_torch/csrc/mc_secant.cu"
    print(json.dumps({"kernels": [
        {"name": "mc_secant", "route": "cuda", "source": src,
         "replaces": "troute_tpu/ops/muskingum_pallas.py:42",
         "launches": m["launches"] + s["launches"]["mc_secant"],
         "max_abs_err": m["max_abs"], "ms": m["ms"],
         "plain_ms": m["plain_ms"]},
        {"name": "mc_secant_skip", "route": "cuda", "source": src,
         "replaces": "troute_tpu/ops/muskingum_pallas.py:51",
         "launches": s["launches"]["mc_secant_skip"],
         "max_abs_err": s["max_abs"], "ms": s["ms"],
         "plain_ms": s["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

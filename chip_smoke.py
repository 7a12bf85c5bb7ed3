#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``troute_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--baseline DIR] [--phases LIST]
                          [--diffusive-steps N]

1. Device: the card's name and power limit, the torch/CUDA/nvcc versions,
   and the builds from this checkout, started together: the MC kernels
   (``troute_torch/csrc/mc_secant.cu``), the same source with its probe
   kernels and ``-Xptxas -v`` (registers and spills of B1 and B2 in f32
   and f64; no spills allowed), and the host topology library.  From the
   probes' SASS (``cuobjdump``): the instructions and MUFU ops on the
   straight path of one in-bank residual evaluation, for the operation
   bound.
2. Kernel B1 against plain: the kernel and the plain ``solve_block`` on
   the same card, on the CONUS parameter ranges of ``tests/test_muskingum.py``
   (2,729,077 lanes f32 bit for bit, 1,000,000 f64 at rtol 1e-9), per-lane
   trip counts equal, two calls bit-identical, lane counts 0, 1, 31, 33,
   257 and 100,003, retry-heavy lanes interleaved with no-flow lanes, the
   golden values and zero forcing; kernel and plain times in ms, trips
   mean and max, residual evaluations, the SIMT efficiency of one thread
   per lane in 32-lane warps, the bound and the slowest lane alone (the
   floor no scheduling removes).
3. Engine, card against CPU: ``route_stepped`` on a 100,000-segment
   synthetic network with level-pool reservoirs and gages, 24 steps, on
   the card (kernel) and on the CPU (plain), in f64 (``check_f64_network``)
   and f32 (the f32 bar); each f32 value past 5e-2 is listed with its
   node type (reservoir, gage, gage neighbour or plain), its step, and
   which f32 run (card or CPU) lies nearer the CPU's f64 run on it.
4. Main path at CONUS scale: the port's synthetic CONUS network
   (``troute_torch/synthetic.py``: 2,729,077 segments, dt 300 s, 24 steps
   per window, qts 12, f32) through ``route_stepped`` on the card, cold and
   warm windows, with the kernel's launches counted; then B1 and the plain
   version on one warm step's inputs, with phase 2's checks and numbers.
5. Kernel B2 against plain: the block-skip kernel and the plain
   ``solve_block_skip`` on the card, on the CONUS ranges (2,729,077 f32
   lanes bit for bit, 1,000,000 f64 lanes at rtol 1e-9), for four
   activity patterns; active blocks equal B1, inactive blocks ``prev``;
   B2, plain and B1 ms per pattern (f32).
6. Strict engine, card against CPU: ``route_stepped``'s strict fixed-point
   mode (accelerator "auto", block skip on) on a 25,000-segment network
   with 25 reservoirs and 50 gages, 3 steps from a warm state, f64 (rtol
   1e-9, atol 1e-8) and f32 (the f32 bar, at most 1e-3 of the values past
   rtol/atol 1e-4); the card's B1/B2 launches equal the driver's own MC
   call counts.
7. Strict path at CONUS scale: ``bench.py:482-515`` and
   ``benchmarks/bench_strict_skip.py`` of the JAX package, on the port,
   from phase 4's warm state: 12-step strict windows (qts 2, f32) with
   ``strict_block_skip`` off and on (accelerator "auto"), and with the
   accelerator off, one warm-up window each, then 4 interleaved timed
   turns, with launches counted; one profiled window of each for the
   device's idle share; then B2 and the plain version on one real skip
   sweep's inputs, captured from a further window, with B2's bound and its
   slowest solved lane alone.
8. The command line on the card: a geopackage of the synthetic CONUS
   network (2,729,077 flowpaths, level-pool lakes, gages), NEXOUT CSV
   forcing for 2 run sets of 24 steps and a YAML control file are written
   under a temporary directory, and ``troute_torch.cli.main_v04(["-f",
   ...])`` runs them in short mode: outputs finite, the CSV (and parquet)
   subsets and the lite restarts read back, B1 launched once per step, the
   boundary restart equal to the first run set's last step; ``task_times``
   and seg-ts/s of the route part and of the whole command.  Then the same
   control file on a 25,000-flowpath domain: on the card against
   ``--cpu`` (the f32 bar), two run sets against one (the f32 bar: the
   second set is warm from the first), and 12 steps with
   ``strict_iterative`` and ``strict_block_skip`` on from the first run
   set's restart, so that B2 launches under the command line: B1's and
   B2's launches equal the engine's own MC call counts.  Last, on a
   25,000-flowpath domain, that strict control file (6 steps) on the card
   against ``--cpu``: the strict f32 bar of phase 6.  NetCDF inputs
   (TimeSlice observations for nudging) need ``h5py`` and are not part of
   this phase.
9. ``route()``'s level scan (the schema's default strict configuration):
   a regional network of 100,000 segments in 100 basins of 1,000 (the
   CONUS generator's hop rule within each basin; its giant basins are
   far deeper than real ones), 300 level-pool reservoirs and 300 gages,
   24 steps at dt 300 s, qts 12, from a routed state, in f64 and f32:
   against ``route_stepped``'s fixed point on the card (phase 6's strict
   bars), and over the first 2 steps the card against the CPU (phase 3's
   f64 bar, phase 6's strict f32 bar; on the host the plain MC solve
   costs ~20 ms per level row); B1 launched once per level row per step, equal to
   the engine's count; ms per step, device kernels per step, B1's time
   per level launch and the idle share of one profiled call (f32).  Then
   phase 8's control file at 25,000 flowpaths in 100 equal basins with
   the schema's default compute parameters (the level scan), 6 steps from
   the 15:00 restart, on the card against ``--cpu``.
10. The diffusive solver (``troute_torch/diffusive``) on the JAX
   benchmark's mainstem reach tree (``synthetic.mainstem_tree``: R=2048
   reaches, C=16 nodes, 24 steps of 300 s, saved every step) in four
   configurations: f32 Jacobi with uniform 128-entry tables, f32 and f64
   Jacobi with exact tables, and the f64 wavefront corrector at R=256.
   Each: the card against the port's CPU run at R=256 over 4 steps (f64
   rtol 1e-9 on all but 1e-5 of the values; f32 the f32 bar on q and
   surfaces within 1e-3 m; all finite), seg-ts/s (valid nodes x steps /
   the seconds of one run after a 2-step warm-up: 12 steps for the
   uniform-table leg, 6 for the others), sub-steps, sweeps per sub-step,
   Newton iterations per ``rtsafe`` call, host syncs per sub-step, device
   kernels per sub-step and the idle share of one profiled 1-step run,
   and (Jacobi) the device ms of one predictor call in each form.  Every
   configuration is bound by launches from the host, so a run costs about
   as much at R=256 as at R=2048 and its time follows the steps (20-60 s
   per 24 steps), which the script's time limit rations.  Then 8 trees of
   256 reaches (f32, Jacobi, uniform tables) as one [8, 256, 16] call on
   the card over 2 steps, against 8
   solo calls (rtol 1e-12) and against the CPU.
11. Hybrid routing and BMI on the card.  (a) ``synthetic.hybrid_regional``:
   phase 9's regional network (100,000 segments in 100 basins) as an
   in-memory RouteLink domain, 8 of whose basins carry a diffusive
   mainstem (40-64 junction-broken reaches each, ~2,700 segments), built
   by ``HybridDomain.from_routelink`` (no RouteLink file: the host may
   lack ``h5py``); every other tree reads natural cross sections from a
   HYFeatures parquet file, 2 tailwaters take a coastal depth series.
   MC routes the rest with ``route_stepped`` (f32, 24 steps, qts 12, B1
   launches = steps), then ``routing/hybrid.py:run_mainstem`` routes the
   mainstem with the "auto" diffusive configuration of the card (f32,
   uniform 128-entry tables), one batch lane per tree: outputs finite;
   MC and diffusive seconds, mainstem seg-ts/s, sub-steps and sweeps,
   and the idle share and kernels per sub-step of one profiled 1-step
   run; over 1 step the batch against solo runs of its 8 trees in
   float64 with exact tables (rtol 1e-12; in float32 trees of different
   widths leave last-bit differences); on 2 trees over 2 steps the card
   against the CPU, float64
   with exact tables at phase 10's f64 bar and float32 with uniform
   tables at its f32 bar.  (b) The routing BMI
   (``bmi/bmi_troute.py:BmiTroute``) on the card: phase 9's network (300
   level-pool lakes as BMI waterbodies) pushed through ``set_value`` with
   a constant lateral inflow; 12 one-hour ``update_until`` calls in short
   mode, bit for bit equal to one 144-step ``route_stepped`` call; ms
   per update and the share spent in ``set_value``/``get_value``, device
   kernels and the idle share of one profiled update; then, from that
   warm state, 2 one-hour updates with ``assume_short_ts: False``
   (``route()``'s fixed point) against ``route_stepped``'s strict fixed
   point (phase 6's strict f32 bar), with sweeps per step; B1 launches
   per update equal to the engine's count; 2 updates of one step in each
   mode on the card against the CPU.
12. Multi-GPU routing on one card (``troute_torch/parallel``).  The card's
   host has one GPU and NCCL refuses two ranks on one GPU, so: (a) phase
   4's CONUS set-up (2,729,077 segments, f32, dt 300 s, 24 steps, qts
   12) in a 1-rank NCCL group on ``cuda:0``: ``route_sharded_global`` in
   short mode bit for bit equal to ``route_stepped``, B1 launched once per
   step, the seg-ts/s of the sharded short driver and of
   ``route_stepped`` in interleaved turns, and the partition's host
   seconds at 1 and 4 ranks; (b) one spawn of 4 gloo ranks, every rank
   on ``cuda:0`` (gloo sends host tensors, so the exchange is staged
   through host memory): phase 9's regional network at world sizes 2 and
   4, ``balanced_assignment`` with one more cut inside a basin, 24 short
   steps in f64 and f32 and 6 strict f32 steps from a warm state against
   ``route_stepped`` on the card (phase 3's f64 bar and f32 share,
   phase 6's strict f32 bar), ``neighbor`` = ``allgather`` bit for bit,
   every rank's result the same, B1 launches per rank equal to its
   drivers' counts, no JAX in any rank; cut edges, exchange rounds, ms
   per step of the short driver, one exchange and B1 on the boundary rows
   (shared-card, host-staged numbers: they do not measure scaling); (c)
   on 2 of those ranks, ``run_mainstem``'s sharded branch (phase 11's 8
   trees, float64 exact tables, 1 step) against the unsharded batch (rtol
   1e-12); (d) the command line with ``parallel_compute_method:
   sharded`` in 2 gloo ranks on a 25,000-flowpath domain (phase 8's
   control file, 6 steps) against the single-process command on the card
   (the f32 bar): rank 0 writes the files, rank 1 none, and each rank's
   B1 launches equal its command's MC count.  The phase-12 launches of
   the result line are the sharded drivers' own: the world-size-1
   ``route_sharded_global`` call, the ranks' cases of (b) and (c) and the
   ranks of (d); the references, the timed turns and the single-process
   command are not counted.

13. Kernel L1 against plain, run right after phase 2: the level-pool
   kernel (``troute_torch/csrc/levelpool.cu``) and the plain
   ``levelpool_step`` on the card at the main path's shapes (CONUS: 5,441
   lakes on 2,729,077 node rows, parameters as ``from_array`` lays them
   out), in f32 and f64, with elevations across every discharge branch:
   the lane form with and without lateral inflow, and the row form with
   and without ``into``, bit for bit (``torch.equal``) with the plain
   step plus ``quc[rows]`` and ``index_put`` on the same inputs, one
   launch a call; then, f32 row form with ``into`` (the short step's
   form), the kernel's device time of one call and the plain lake block's
   (profiler), the interval at which the wrapper enqueues calls back to
   back (CUDA events), and the bound: the bytes that call must move over
   the HBM rate.  Every other phase that routes on the card counts L1's
   launches from zero before each run and checks them after it: one a
   short step with lakes (phases 3, 8, 11 and the lakeless CONUS windows
   of phases 4 and 12 with none), one a sweep in the strict Jacobi sweeps
   (phases 6 and 8: B1's and B2's launches together), the same number in
   each step of the level scan (phase 9).  The ranks that phase 12
   spawns are not counted.
14. Kernel L1's DA form against the block it replaces, run right after
   phase 13: at the AnA cell's shapes (5,441 lakes on 2,729,077 node rows,
   193 persistence observations, 76 RFC values; 436 persistence, 78 RFC
   and 48 Great Lakes lakes spread over every branch of
   ``tests/reservoir_da_lanes.py``, the rest level pool, in a shuffled
   order), in f32 and f64, the row form with ``into`` and the lane form
   against L1 without DA, the plain ``typed_reservoir_dispatch`` and
   ``index_put`` on the same inputs, bit for bit (NaN where NaN): the
   node tensors or outflow, elevation and depth column, the nine DA state
   fields, and the caller's states untouched; both launch counters
   (every L1 launch, the DA form's) zeroed before and checked after, one
   launch a call.  Then, f32 row form (the AnA step's form), the DA form's
   device time a call and the plain block's (profiler), the interval at
   which each is enqueued back to back (CUDA events), and the bound: the
   bytes the DA form reads and writes on those lakes (each lake's own
   walks counted) over the HBM rate.

``--phases LIST`` (e.g. ``9,10`` or ``2-8``) runs only those phases after
phase 1 and then prints no result lines; the default runs them all.
``--engine-segments N`` runs phase 3 on N segments instead of 100,000
(and prints no result lines): its listing of the f32 values past 5e-2
at another size.  ``--diffusive-steps N`` times every phase-10
configuration over N steps
(``--phases 10 --diffusive-steps 24`` gives 24-step rates for all four;
the whole script would then outrun its time limit on a slow host).

``--baseline DIR`` (a checkout of an earlier commit, e.g. unpacked with
``git archive``: its B1 is either one thread per lane or the persistent
grid with trips, evaluations and the work counter; its B2 either one
CUDA block per flag block with no counter or the persistent grid with
them, declared through ``MC_SECANT_SKIP_ENTRY``) also builds ``DIR/troute_torch/csrc/mc_secant.cu`` and
times both of its kernels in turns with this checkout's (baseline, kernel,
kernel, baseline), bit for bit: B1 on the inputs of phases 2 and 4 and on
each step of one cold and one warm phase-4 window, B2 on phase 7's
captured skip sweep.  At the end it runs this script's phase-4 windows,
phase-7 strict windows and 24 short steps of ``route_stepped`` on phase
9's regional network with ``DIR``'s package and with this one's, each in
a process of its own, in the same turns, for the seg-ts/s (ms per step)
of both; phase 4 logs its network's remainder layers (the ``index_add``
calls of one upstream sum's remainder).

Every check raises on failure, so the script exits non-zero; so does a
run that imported any module of JAX, of the JAX package or its
``bench.py``.  It exits 1, printing no result, when no CUDA device is
visible or it is not run from a checkout.  The line before last is a JSON
object with the kernels' measurements; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
NAMES = ("qup", "quc", "qdp", "ql", "dx", "bw", "tw", "twcc", "n", "ncc",
         "cs", "s0", "depthp")
DT = 300.0
N_CONUS = 2_729_077
# the level-pool lakes of the benchmark's CONUS network
N_CONUS_LAKES = 5_441
# phase 9's regional network: 100 basins of 1,000 segments
N_REGION, N_BASINS = 100_000, 100

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

# NVIDIA H100 SXM: SMs, FP32 lanes and MUFU ops per clock per SM, HBM3
# bytes per second (NVIDIA's H100 SXM datasheet); the SM clock is read
# from nvidia-smi
SMS, FP32_PER_CLK, MUFU_PER_CLK, HBM_BYTES_PER_S = 132, 128, 16, 3.35e12


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


def check_f64(got_list, want_list, what: str, inputs=None) -> np.ndarray:
    """rtol 1e-9, atol 1e-12 per lane.  With ``inputs`` (MC lanes), a lane
    off that bar is settled by the scalar oracle: the kernel must be at
    least as close to it as the plain version (at most 0.5% of lanes).
    Returns the lanes so settled."""
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
    return lanes


def check_strict_f32(got, want, what: str) -> str:
    """The strict runs' f32 bar.  The f32 secant stops on a relative step,
    so a last-ulp difference can change a lane's trip count and move the
    strict fixed point past rtol/atol 1e-4 on a few values; on the CPU
    alone, a 2-ulp nudge of a warm start does so on 166 of 900,000 values
    (max rel 1.3e-2).  So: the f32 bar, and at most 1e-3 of the values past
    rtol/atol 1e-4.  Returns the reading as text."""
    ok = ~np.isnan(want)
    st = check_f32_bar(got[ok], want[ok], what, max_share=1e-5)
    off = int((~np.isclose(got[ok], want[ok], rtol=1e-4, atol=1e-4)).sum())
    if off > 1e-3 * ok.sum():
        raise AssertionError(f"{what}: {off} values past rtol/atol 1e-4")
    return (f"f32 bar: median {st['median']:.3g}, p95 {st['p95']:.3g}, max "
            f"{st['max']:.3g}; {off} of {ok.sum()} values past rtol/atol "
            f"1e-4, max abs {float(np.abs(got[ok] - want[ok]).max()):.3g}")


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


def smi_query(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields> --format=csv,noheader`` of the
    first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def ptxas_report(text: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} from ``-Xptxas -v`` output."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)([^;]*);")


def sass_functions(lib: Path) -> dict:
    """{mangled function: [(address, predicate, opcode, operands)]} from
    the SASS of ``lib`` (``cuobjdump -sass``)."""
    from troute_torch import _build
    tool = Path(_build.find_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _SASS_LINE.search(line)
        if m and name:
            out[name].append((int(m.group(1), 16), (m.group(2) or "").strip(),
                              m.group(3), m.group(4).strip()))
    return out


def straight_path(code: list) -> tuple[int, int]:
    """(instructions, MUFU ops) that one thread issues from the entry of
    ``code`` (``sass_functions``) to its EXIT on the straight path, NOPs
    left out: a conditional branch falls through, unless the code it
    would fall into calls a subroutine (the slow paths of IEEE divide and
    sqrt) before its next branch or join; an unconditional branch or a
    call is followed."""
    at = {a: k for k, (a, *_) in enumerate(code)}

    def walk(k: int) -> tuple[int, int]:
        n = mufu = 0
        seen = set()
        while True:
            a, pred, op, args = code[k]
            if a in seen:
                raise AssertionError(f"SASS path loops at {a:#x}")
            seen.add(a)
            if not op.startswith("NOP"):
                n, mufu = n + 1, mufu + op.startswith("MUFU")
            if (op == "EXIT" and not pred) or op.startswith("RET"):
                return n, mufu
            if op in ("BRX", "JMX", "JMP"):
                raise AssertionError(f"SASS {op} at {a:#x}")
            if op.startswith("CALL"):
                cn, cm = walk(at[int(args.split()[0], 16)])
                n, mufu = n + cn, mufu + cm
            elif op == "BRA":
                target = at[int(args.split()[-1], 16)]
                j = k + 1
                while not code[j][2].startswith(("BRA", "EXIT", "BSYNC",
                                                 "CALL", "RET")):
                    j += 1
                if pred in ("", "@PT") or code[j][2].startswith("CALL"):
                    k = target
                    continue
            k += 1

    return walk(0)


def _kernel_of(report: dict, pattern: str):
    hits = [v for k, v in report.items() if re.search(pattern, k)]
    if len(hits) != 1:
        raise AssertionError(f"{pattern}: {len(hits)} matches in "
                             f"{sorted(report)}")
    return hits[0]


def phase_device(device) -> dict:
    """Versions, the builds (started together) and what the compiler says
    about B1 and B2: registers, spills, SASS of one residual evaluation."""
    import torch
    from troute_torch import _build, native
    smi = smi_query("name,power.limit")
    log(smi)
    clock_mhz = float(smi_query("clocks.max.sm").split()[0])
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {nvcc}; max SM clock "
        f"{clock_mhz:.0f} MHz")
    log(f"device {device}: {torch.cuda.get_device_name(device)}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        kernels = pool.submit(_build.build, "mc_secant")
        probes = pool.submit(_build.build, "mc_secant",
                             ("-Xptxas", "-v", "-DMC_SECANT_PROBES"))
        host = pool.submit(native.available)
        (lib, _), (probe_lib, ptxas), host_ok = (
            kernels.result(), probes.result(), host.result())
    _build.load("mc_secant")
    if not host_ok:
        raise AssertionError("the host topology library did not build "
                             "(troute_torch/native.py logged why)")
    log(f"phase 1: built {lib.relative_to(ROOT)}, "
        f"{probe_lib.relative_to(ROOT)} (probes, -Xptxas -v) and the host "
        f"topology library in {time.perf_counter() - t0:.2f} s")
    import importlib.util
    have = {m: importlib.util.find_spec(m) is not None
            for m in ("pandas", "pydantic", "yaml", "sqlite3", "pyarrow",
                      "h5py", "netCDF4")}
    log(f"phase 1: packages the command line may use: {have}")
    for m in ("pandas", "pydantic", "yaml", "sqlite3"):
        if not have[m]:
            raise AssertionError(f"the command line needs {m}")
    regs = ptxas_report(ptxas)
    usage = {}
    for name, pat in (("B1 f32", r"mc_secant_kernelIf"),
                      ("B1 f64", r"mc_secant_kernelId"),
                      ("B2 f32", r"mc_secant_skip_kernelIf"),
                      ("B2 f64", r"mc_secant_skip_kernelId")):
        r, st, ld = _kernel_of(regs, pat)
        if st or ld:
            raise AssertionError(f"{name} spills: {st} B stored, {ld} B "
                                 "loaded")
        usage[name] = r
    sass = sass_functions(probe_lib)
    i0, m0 = straight_path(_kernel_of(sass, r"probe_eval0IfE"))
    i1, m1 = straight_path(_kernel_of(sass, r"probe_eval1IfE"))
    per_eval = dict(instr=i1 - i0, mufu=m1 - m0)
    log(f"phase 1: registers (-Xptxas -v), no spills: {usage}; SASS of one "
        f"f32 residual evaluation (probe kernels' difference, straight "
        f"in-bank path, no divide or sqrt slow path): {per_eval['instr']} "
        f"instructions, {per_eval['mufu']} MUFU")
    return dict(smi=smi, clock_hz=clock_mhz * 1e6, per_eval=per_eval,
                registers=usage, pyarrow=have["pyarrow"])


def kernel_bound(dev: dict, n_bytes: float, lane_evals: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the residual evaluations' SASS (each the straight
    in-bank path, ``phase_device``) over the issue rate (128 lanes per SM
    per clock) or their MUFU ops over the MUFU rate (16 per SM per clock),
    at the card's max SM clock.  Passes that evaluate nothing, refills and
    overbank code are left out, so the operations are counted low."""
    clk = dev["clock_hz"]
    b_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    issue_ms = 1e3 * lane_evals * dev["per_eval"]["instr"] / (
        SMS * FP32_PER_CLK * clk)
    mufu_ms = 1e3 * lane_evals * dev["per_eval"]["mufu"] / (
        SMS * MUFU_PER_CLK * clk)
    ops_ms = max(issue_ms, mufu_ms)
    return dict(bound_ms=max(b_ms, ops_ms),
                bound_by="bytes" if b_ms >= ops_ms else "operations",
                bytes_ms=b_ms, issue_ms=issue_ms, mufu_ms=mufu_ms)


def trip_stats(trips, evals) -> dict:
    """Mean and max trips, the lane-trips, the residual evaluations, and
    the SIMT efficiency that one thread per lane in 32-lane warps had:
    lane-trips / (32 x the sum over warps of the warp's slowest lane);
    ``block`` the same over 256-lane blocks, since a block held its SM
    slot until its slowest warp ended."""
    t = trips.cpu().numpy().astype(np.int64)
    e = evals.cpu().numpy().astype(np.int64)

    def eff(width):
        w = np.zeros(-(-t.size // width) * width, np.int64)
        w[:t.size] = t
        return float(t.sum()) / max(
            width * int(w.reshape(-1, width).max(axis=1).sum()), 1)

    return dict(mean=float(t.mean()) if t.size else 0.0,
                max=int(t.max()) if t.size else 0, lane_trips=int(t.sum()),
                evals_mean=float(e.mean()) if e.size else 0.0,
                lane_evals=int(e.sum()), simt=eff(32), block=eff(256))


class Baseline:
    """An earlier checkout's kernels, built from its source ``src`` and
    called through their C interfaces.  B1 (``__call__``): 13 inputs, dt, 6
    outputs, then, where the source's B1 is the persistent grid, trips,
    evaluations and the work counter, then nseg and the stream.  B2
    (``skip``, f32): the 6 ``prev`` and the int32 block flags after the
    outputs; where the source declares its entries through
    ``MC_SECANT_SKIP_ENTRY`` (the persistent B2), trips, evaluations and
    the work counter follow, else (one CUDA block per flag block) none."""

    def __init__(self, src: Path):
        from troute_torch import _build
        path, _ = _build.compile_cached(_build.find_nvcc(),
                                        _build.NVCC_FLAGS, src)
        self.lib, self.fn = ctypes.CDLL(str(path)), {}
        text = src.read_text()
        self.skip_counter = "MC_SECANT_SKIP_ENTRY(" in text
        self.counter = self.skip_counter or re.search(
            r"int mc_secant_f32\([^)]*int32_t\* next", text) is not None
        for dt, name, c_real in (("float32", "mc_secant_f32", ctypes.c_float),
                                 ("float64", "mc_secant_f64",
                                  ctypes.c_double)):
            fn = getattr(self.lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 13 + [c_real]
                           + [ctypes.c_void_p] * (9 if self.counter else 6)
                           + [ctypes.c_int64, ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self.fn[dt] = fn
        self.skip_fn = self.lib.mc_secant_skip_f32
        self.skip_fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_float]
                                 + [ctypes.c_void_p]
                                 * (16 if self.skip_counter else 13)
                                 + [ctypes.c_int64, ctypes.c_void_p])
        self.skip_fn.restype = ctypes.c_int
        log(f"built {path.name} from {src} (its B1 "
            f"{'persistent' if self.counter else 'one thread per lane'})")

    def skip(self, args, diag: bool, prev, flags):
        """The baseline's B2 (f32) on ``args`` with int32 block ``flags``."""
        import torch
        n_out = 6 if diag else 3
        out = [torch.empty_like(args[0]) for _ in range(n_out)]
        ptrs = [o.data_ptr() for o in out] + [None] * (6 - n_out) \
            + [p.data_ptr() for p in prev[:n_out]] + [None] * (6 - n_out) \
            + [flags.data_ptr()]
        if self.skip_counter:
            counter = torch.zeros(1, dtype=torch.int32, device=args[0].device)
            ptrs += [None, None, counter.data_ptr()]
        rc = self.skip_fn(*[a.data_ptr() for a in args], DT, *ptrs,
                          args[0].shape[0],
                          torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"baseline B2 launch failed: CUDA error {rc}")
        return out

    def __call__(self, args, diag: bool):
        import torch
        out = [torch.empty_like(args[0]) for _ in range(6 if diag else 3)]
        ptrs = [o.data_ptr() for o in out] + [None] * (6 - len(out))
        if self.counter:
            counter = torch.zeros(1, dtype=torch.int32, device=args[0].device)
            ptrs += [None, None, counter.data_ptr()]
        stream = torch.cuda.current_stream().cuda_stream
        rc = self.fn[str(args[0].dtype).split(".")[-1]](
            *[a.data_ptr() for a in args], DT, *ptrs, args[0].shape[0],
            stream)
        if rc != 0:
            raise RuntimeError(f"baseline B1 launch failed: CUDA error {rc}")
        return out


def b1_gate(args, what: str, diag: bool = True, inputs=None):
    """B1 against the plain ``solve_block`` on the same card: f32 bit for
    bit, f64 at rtol 1e-9 (``check_f64``), per-lane trips and evaluations
    equal (in f64, a lane that ``check_f64`` settled by the scalar oracle
    may differ), and a second call bit-identical.  Returns the kernel's
    outputs as NumPy, its trips and evaluations, and the max abs
    difference."""
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.muskingum import solve_block
    n_out = 6 if diag else 3
    k_out, k_trips, k_evals = mcc.muskingum_cunge_cuda(
        *args, DT, with_diagnostics=diag, return_trips=True)
    again, again_trips, again_evals = mcc.muskingum_cunge_cuda(
        *args, DT, with_diagnostics=diag, return_trips=True)
    p_out = solve_block(*args, dt=DT, return_trips=True)
    torch.cuda.synchronize()
    got = [o.cpu().numpy() for o in k_out[:n_out]]
    want = [o.cpu().numpy() for o in p_out[:n_out]]
    if not (torch.equal(k_trips, again_trips)
            and torch.equal(k_evals, again_evals)) or not all(
            np.array_equal(g, a.cpu().numpy(), equal_nan=True)
            for g, a in zip(got, again)):
        raise AssertionError(f"{what}: two kernel calls differ")
    settled = np.zeros(0, np.int64)
    if args[0].dtype == torch.float32:
        for k, (g, w) in enumerate(zip(got, want)):
            if not np.array_equal(g, w, equal_nan=True):
                raise AssertionError(f"{what}: output {k} not bit for bit")
    else:
        settled = check_f64(got, want, what, inputs=inputs)
    counts_off = np.flatnonzero(((k_trips != p_out[6])
                                 | (k_evals != p_out[7])).cpu().numpy())
    if not np.isin(counts_off, settled).all():
        raise AssertionError(f"{what}: kernel trips or evaluations differ "
                             f"from plain on {counts_off.size} lanes")
    max_abs = max((float(np.abs(g - w).max()) for g, w in zip(got, want)
                   if g.size), default=0.0)
    if counts_off.size:
        log(f"{what}: trips differ from plain on {counts_off.size} lanes, "
            "each settled by the scalar oracle")
    return got, k_trips, k_evals, max_abs


def b1_numbers(dev: dict, args, trips, evals, diag: bool, what: str,
               smi: str, baseline=None) -> dict:
    """Times of B1 and the plain version on ``args`` (and of the baseline,
    in turns), the bound from these inputs' trips, and the slowest lane
    alone."""
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.muskingum import solve_block
    n, st = int(args[0].shape[0]), trip_stats(trips, evals)
    item = args[0].element_size()
    bound = kernel_bound(dev, n * (13 + (6 if diag else 3)) * item,
                         st["lane_evals"])

    def b1():
        return mcc.muskingum_cunge_cuda(*args, DT, with_diagnostics=diag)

    if baseline is not None:
        got, want = baseline(args, diag), b1()
        if not all(np.array_equal(g.cpu().numpy(), w.cpu().numpy(),
                                  equal_nan=True)
                   for g, w in zip(got, want)):
            raise AssertionError(f"{what}: baseline and kernel differ")
        base = [cuda_ms(lambda: baseline(args, diag), reps=10)]
        ms = [cuda_ms(b1, reps=10), cuda_ms(b1, reps=10)]
        base.append(cuda_ms(lambda: baseline(args, diag), reps=10))
    else:
        ms, base = [cuda_ms(b1, reps=10)], []
    # the plain version's gate call was its warm-up
    p_ms = cuda_ms(lambda: solve_block(*args, dt=DT), reps=1, warm_up=False)
    i = int(trips.argmax())
    one = [a[i:i + 1].contiguous() for a in args]
    floor_ms = cuda_ms(lambda: mcc.muskingum_cunge_cuda(
        *one, DT, with_diagnostics=diag), reps=20)
    cyc = floor_ms * 1e-3 * dev["clock_hz"] / max(st["max"], 1)
    log(f"{what}: {n} lanes: B1 {' / '.join(f'{t:.4f}' for t in ms)} ms"
        + (f", baseline {' / '.join(f'{t:.4f}' for t in base)}"
           f" ms (in turns: baseline, B1, B1, baseline)" if base else "")
        + f", plain {p_ms:.3f} ms; trips mean {st['mean']:.4f} max "
        f"{st['max']}, lane-trips {st['lane_trips']}, residual evaluations "
        f"{st['lane_evals']} (mean {st['evals_mean']:.4f}), SIMT efficiency "
        f"of one "
        f"thread per lane {st['simt']:.4f} (per 256-lane block "
        f"{st['block']:.4f}); bound {bound['bound_ms']:.4f} ms "
        f"({bound['bound_by']}: bytes {bound['bytes_ms']:.4f}, issue "
        f"{bound['issue_ms']:.4f}, MUFU {bound['mufu_ms']:.4f} ms); slowest "
        f"lane alone {floor_ms:.4f} ms ({st['max']} trips, ~{cyc:.0f} cycles "
        f"per trip at the max clock)  [{smi}]")
    return dict(ms=min(ms), ms_all=ms, baseline_ms=base, plain_ms=p_ms,
                trips_mean=st["mean"], trips_max=st["max"],
                evals_mean=st["evals_mean"], lane_trips=st["lane_trips"],
                lane_evals=st["lane_evals"], simt_one_per_lane=st["simt"],
                block_one_per_lane=st["block"],
                floor_ms=floor_ms, **bound)


def phase_kernel_vs_plain(device, dev: dict, n32: int, n64: int,
                          baseline=None) -> dict:
    import torch
    from troute_torch.ops import muskingum_cuda as mcc

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
        out, trips, evals = mcc.muskingum_cunge_cuda(
            z, z, z, z, 1800.0 * one, 112.0 * one, 448.0 * one, 623.6 * one,
            0.028 * one, 0.031 * one, 1.4 * one, 0.0018 * one, z, DT,
            return_trips=True)
        torch.cuda.synchronize()
        for o in (out.qdc, out.velc, out.depthc, out.X, trips, evals):
            if bool((o != 0).any()):
                raise AssertionError("zero forcing gave a nonzero output")
    log("phase 2: golden values and zero forcing (0 trips) pass (f32, f64)")

    res = {}
    for dtype, n in ((torch.float32, n32), (torch.float64, n64)):
        inputs = conus_range_inputs(n, seed=0)
        args = [on_card(a, dtype) for a in inputs]
        _, trips, evals, max_abs = b1_gate(args, f"conus-range {dtype}",
                                           inputs=inputs)
        want_bar = "bit for bit" if dtype == torch.float32 else "rtol 1e-9"
        for m in (0, 1, 31, 33, 257, 100_003):
            b1_gate([a[:m] for a in args], f"{dtype} first {m} lanes",
                    inputs=[a[:m] for a in inputs])
        # retry-heavy lanes (over 100 trips) interleaved with no-flow lanes
        heavy = torch.nonzero(trips > 100).flatten()[:4096]
        mix = []
        for k, a in enumerate(args):
            h = a[heavy]
            z = torch.zeros_like(h) if NAMES[k] in ("qup", "quc", "qdp", "ql") \
                else h
            mix.append(torch.stack([h, z], dim=1).reshape(-1).contiguous())
        _, mix_trips, _, _ = b1_gate(mix, f"{dtype} retry-heavy mix",
                                     inputs=[a.cpu().numpy() for a in mix])
        log(f"phase 2: B1 vs plain {dtype}, {n} lanes, 6 outputs: {want_bar}, "
            f"trips and evaluations equal, two calls identical, max abs "
            f"{max_abs:.3g}; also "
            f"at 0, 1, 31, 33, 257, 100003 lanes and on {heavy.numel()} "
            f"retry-heavy lanes (trips {int(mix_trips.min())}-"
            f"{int(mix_trips.max())}) interleaved with no-flow lanes")
        if dtype == torch.float32:
            res = b1_numbers(dev, args, trips, evals, True,
                             "phase 2: conus-range f32", dev["smi"], baseline)
            res["max_abs"] = max_abs
        del args
    return res


# kernel L1's launches checked by each phase, by phase
L1_BY_PATH: dict[int, int] = {}


def l1_reset() -> None:
    from troute_torch.ops import levelpool_cuda
    levelpool_cuda.LAUNCHES = 0


def l1_read(want, what: str, phase: int) -> int:
    """Kernel L1's launches since ``l1_reset``, added to ``phase``'s count;
    they must equal ``want`` (None: any number)."""
    from troute_torch.ops import levelpool_cuda
    got = levelpool_cuda.LAUNCHES
    if want is not None and got != want:
        raise AssertionError(f"{what}: kernel L1 launched {got} times, "
                             f"expected {want}")
    L1_BY_PATH[phase] = L1_BY_PATH.get(phase, 0) + got
    return got


def _lake_inputs(device, dtype, n_res: int, n_nodes: int, seed: int):
    """``n_res`` lakes on distinct rows of ``n_nodes``: parameters from
    ``tests/test_torch_cuda.py``'s ranges as ``from_array`` lays them out
    (column views of one [n, 9] array), a fifth of the lakes with no area,
    and elevations from below the orifice to over the top, so that every
    branch of the discharge is taken; inflows to 500 m3/s."""
    import torch
    from troute_torch.ops.levelpool import LevelpoolParams
    rng = np.random.default_rng(seed)
    ranges = ((0.5, 20.0), (9.0, 11.0), (0.5, 2.0), (0.05, 0.2), (6.0, 8.0),
              (0.3, 0.5), (8.5, 9.5), (5.0, 20.0), (0.0, 1.0))
    wb = np.stack([rng.uniform(lo, hi, n_res) for lo, hi in ranges], axis=1)
    wb[:, 1] = np.maximum(wb[:, 1], wb[:, 6] + 0.2)
    wb[::5, 0] = 0.0
    h = rng.uniform(wb[:, 4] - 1.0, wb[:, 1] + 1.0)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    rows = torch.as_tensor(np.sort(rng.choice(n_nodes, n_res,
                                              replace=False)), device=device)
    return dict(p=LevelpoolParams.from_array(wb, device=device, dtype=dtype),
                H=t(h), qi0=t(rng.uniform(0, 500, n_res)),
                qi1=t(rng.uniform(0, 500, n_res)),
                ql=t(rng.uniform(0, 5, n_res)), rows=rows,
                quc=t(rng.uniform(0, 500, n_nodes)),
                q=t(rng.uniform(0, 500, n_nodes)),
                d=t(rng.uniform(0, 10, n_nodes)))


def phase_levelpool(device, dev: dict, n_res: int, n_nodes: int) -> dict:
    """Phase 13: kernel L1 against the plain level pool on the card (the
    module docstring)."""
    import torch
    from troute_torch.ops import levelpool_cuda
    from troute_torch.ops.levelpool import levelpool_step
    smi = dev["smi"]
    max_abs = 0.0
    l1_reset()
    for dtype in (torch.float32, torch.float64):
        x = _lake_inputs(device, dtype, n_res, n_nodes, seed=13)
        p, H, rows, quc = x["p"], x["H"], x["rows"], x["quc"]
        zeros = torch.zeros_like(H)
        inflow = quc[rows]
        want = {"lanes": levelpool_step(H, x["qi0"], x["qi1"], x["ql"], DT, p),
                "lanes, ql None": levelpool_step(H, x["qi0"], x["qi1"],
                                                 zeros, DT, p),
                "rows": levelpool_step(H, inflow, inflow, zeros, DT, p)}
        want["rows"] += (inflow,)
        out, h_new = want["rows"][:2]
        q_in, d_in = x["q"].clone(), x["d"].clone()
        got = {"lanes": levelpool_cuda.levelpool_step_cuda(
                   H, x["qi0"], x["qi1"], x["ql"], DT, p),
               "lanes, ql None": levelpool_cuda.levelpool_step_cuda(
                   H, x["qi0"], x["qi1"], None, DT, p),
               "rows": levelpool_cuda.levelpool_rows_cuda(H, quc, rows, DT,
                                                           p)}
        h_into = levelpool_cuda.levelpool_rows_cuda(H, quc, rows, DT, p,
                                                    into=(q_in, d_in))
        got["rows, into"] = (h_into, q_in, d_in)
        want["rows, into"] = (h_new, x["q"].index_put((rows,), out),
                              x["d"].index_put((rows,), h_new))
        torch.cuda.synchronize()
        for form, gs in got.items():
            for k, (g, w) in enumerate(zip(gs, want[form])):
                if g.dtype != dtype or g.shape != w.shape:
                    raise AssertionError(f"phase 13: L1 {form} {dtype} "
                                         f"output {k}: {g.dtype} "
                                         f"{tuple(g.shape)}")
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"phase 13: L1 {form} {dtype} "
                                         f"output {k} not finite")
                max_abs = max(max_abs, float((g - w).abs().max()))
                if not torch.equal(g, w):
                    raise AssertionError(f"phase 13: L1 {form} {dtype} "
                                         f"output {k} differs from the "
                                         f"plain level pool, max abs "
                                         f"{float((g - w).abs().max()):.3g}")
        branches = {
            "over the top": int((H > p.max_depth).sum()),
            "weir": int(((H <= p.max_depth) & (H > p.weir_elev)).sum()),
            "orifice": int(((H <= p.weir_elev)
                            & (H > p.orifice_elev)).sum()),
            "below the orifice": int((H <= p.orifice_elev).sum()),
            "no area": int((p.area == 0).sum())}
        log(f"phase 13: L1 vs plain {dtype}, {n_res} lakes on {n_nodes} "
            f"rows: lane form (ql given, ql None) and row form (without and "
            f"with into: outflow, elevation, inflow, q[rows], d[rows]) bit "
            f"for bit; first evaluation's branches {branches}")
    l1_read(8, "phase 13's checks", 13)

    # the short step's form, f32: device time, enqueue interval, bound
    x = _lake_inputs(device, torch.float32, n_res, n_nodes, seed=14)
    p, H, rows, quc, q, d = (x[k] for k in ("p", "H", "rows", "quc", "q",
                                            "d"))

    def l1():
        levelpool_cuda.levelpool_rows_cuda(H, quc, rows, DT, p, into=(q, d))

    def plain():
        inflow = quc[rows]
        o, h = levelpool_step(H, inflow, inflow, torch.zeros_like(inflow),
                              DT, p)
        q.index_put((rows,), o)
        d.index_put((rows,), h)

    calls = {"l1": 200, "plain": 20}
    l1_reset()
    l1()            # packs the parameters
    plain()
    torch.cuda.synchronize()
    prof = {name: profile_window(lambda: [fn() for _ in range(calls[name])],
                                 host_ops=False)
            for name, fn in (("l1", l1), ("plain", plain))}
    enqueue = {"l1": cuda_ms(l1, reps=2000), "plain": cuda_ms(plain, reps=50)}
    l1_read(1 + calls["l1"] + 2001, "phase 13's timed calls", 13)
    if prof["l1"]["busy_ms"] is None:
        ms = plain_ms = None
        plain_kernels = None
    else:
        # by_name: device ms of each kernel over the profiled calls
        l1_ms = [v for k, v in prof["l1"]["by_name"].items()
                 if "levelpool" in k]
        if prof["l1"]["counts"] != {k: calls["l1"] for k in
                                    prof["l1"]["by_name"]} or len(l1_ms) != 1:
            raise AssertionError(f"phase 13: the profiled L1 calls traced "
                                 f"{prof['l1']['counts']}")
        ms = l1_ms[0] / calls["l1"]
        plain_ms = sum(prof["plain"]["by_name"].values()) / calls["plain"]
        plain_kernels = prof["plain"]["launches"] / calls["plain"]
    # per lake: the row, quc at it, H and the nine parameters read; the
    # new elevation, q[row] and d[row] written
    item = H.element_size()
    n_bytes = n_res * (rows.element_size() + item * (2 + 9) + item * 3)
    bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    log(f"phase 13: f32 row form with into, {n_res} lakes: L1 "
        f"{'not measured' if ms is None else f'{ms * 1e3:.2f} us'} of device "
        f"time a call (profiler, {calls['l1']} calls), the wrapper enqueues "
        f"one every {enqueue['l1'] * 1e3:.2f} us back to back (CUDA events); "
        f"the plain block "
        f"{'not measured' if plain_ms is None else f'{plain_ms * 1e3:.2f} us'}"
        f" of device time over {plain_kernels} kernels a call, one every "
        f"{enqueue['plain'] * 1e3:.2f} us back to back; bound "
        f"{bound_ms * 1e3:.3f} us ({n_bytes / n_res:.0f} B a lake over "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s)  [{smi}]")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                enqueue_ms=enqueue["l1"], plain_enqueue_ms=enqueue["plain"],
                plain_kernels=plain_kernels, bytes_per_lake=n_bytes / n_res,
                max_abs=max_abs)


# the AnA cell's lakes by DA kind (the rest level pool): NWM's CONUS
# persistence and RFC lakes, and Great Lakes lakes of every branch
ANA_DA_LAKES = {"hybrid": 436, "rfc": 78, "great lakes": 48}


def _ana_lakes(device, dtype, n_res: int, n_nodes: int, seed: int) -> dict:
    """``n_res`` lakes of ``tests/reservoir_da_lanes.py`` in the AnA cell's
    mix (``ANA_DA_LAKES``, each kind's lakes spread evenly over its
    branches, the rest level pool), in a shuffled order, on distinct
    sorted rows of ``n_nodes``: ``da_lanes``' dict with ``rows``, the node
    inflows ``quc`` (the lakes' ``inflow`` at their rows) and node tensors
    ``q`` and ``d`` to scatter into."""
    import torch
    import reservoir_da_lanes as rdl
    from troute_torch.ops.levelpool import LevelpoolParams
    from troute_torch.routing import engine
    x = rdl.da_lanes(dtype, device, per_branch=64, seed=seed)
    rng = np.random.default_rng(seed)
    branch = x["branch"]
    names = list(dict.fromkeys(b for _, b in rdl.BRANCHES))
    pick = []
    for kind, total in ANA_DA_LAKES.items():
        kind_names = [b for b in names if b.startswith(kind)]
        for b, k in zip(kind_names, (len(a) for a in np.array_split(
                np.arange(total), len(kind_names)))):
            pick.append(rng.choice(np.flatnonzero(branch == b), k,
                                   replace=False))
    level_pool = np.flatnonzero(np.char.startswith(branch, "level pool"))
    pick.append(rng.choice(level_pool, n_res - sum(map(len, pick))))
    pick = rng.permutation(np.concatenate(pick))
    idx = torch.as_tensor(pick, device=device)
    rd = x["res_da"]
    rd = rd._replace(**{f: getattr(rd, f)[idx] for f in rd._fields
                        if f not in engine._RES_DA_SHARED})
    rows = torch.as_tensor(np.sort(rng.choice(n_nodes, n_res,
                                              replace=False)), device=device)
    inflow = x["inflow"][idx]

    def nodes(hi):
        return torch.as_tensor(rng.uniform(0, hi, n_nodes), dtype=dtype,
                               device=device)

    return dict(x, H=x["H"][idx], inflow=inflow, res_da=rd,
                p=LevelpoolParams(*[c[idx] for c in x["p"]]),
                states=tuple(type(s)(*[f[idx] for f in s])
                             for s in x["states"]),
                branch=branch[pick], rows=rows,
                quc=nodes(500).index_put((rows,), inflow), q=nodes(500),
                d=nodes(10))


def _da_bytes(x) -> tuple[int, dict]:
    """The bytes that L1's DA form, row form with ``into``, reads and
    writes on the lakes ``x`` (``_ana_lakes``), each value once, and the
    mean walk of each kind.  Every lake: its row, ``quc`` there, its
    elevation, nine parameters and type, the nine DA states in and out,
    the new elevation, ``q[row]`` and ``d[row]``.  Persistence lakes: the
    shared observation times once, and the observations their walk back
    reads.  RFC lakes: the flag, then the persist time, count and time
    step as far as their tests go, the series value and the walk back of
    a negative outflow.  Great Lakes lakes: the month's climatology, the
    observation times walked back and one observation."""
    rd, (hyb, rfc, _) = x["res_da"], x["states"]
    item = x["H"].element_size()
    np_dtype = np.float32 if item == 4 else np.float64
    now = np_dtype(x["now"])

    def c(a):
        return a.cpu().numpy()

    def last_true(ok):
        """Per row, the last column where ``ok`` holds, else -1."""
        return np.where(ok.any(1), ok.shape[1] - 1
                        - np.argmax(ok[:, ::-1], axis=1), -1)

    wt = c(rd.wbody_type)
    n = wt.size
    total = n * (8 + item * 11 + 4 + 2 * (8 * item + 4) + item * 3)
    walks = {}
    h = (wt == 2) | (wt == 3)
    times = c(rd.hybrid_obs_time)
    total += times.size * item
    diff = c(hyb.update_time)[h, None] - times[None, :]
    t_idx = np.argmin(np.where(diff >= 0, diff, np.inf), axis=1)
    obs = c(rd.hybrid_obs)[h]
    cols = np.arange(obs.shape[1])
    pick = last_true(~np.isnan(obs) & (cols <= t_idx[:, None]))
    reads = t_idx - pick + (pick >= 0)
    total += item * int(reads.sum())
    walks["hybrid"] = float(reads.mean()) if reads.size else 0.0

    r = (wt == 4) | (wt == 5)
    use = c(rd.rfc_use)[r]
    in_window = use & (now <= c(rd.rfc_persist_seconds)[r])
    test = in_window & (now >= c(rfc.update_time)[r])
    ts = c(rfc.timeseries_idx)[r].astype(np.int64)
    advance = test & (ts < c(rd.rfc_counts)[r])
    series = c(rd.rfc_series)[r]
    idx = np.clip(ts + advance, 0, series.shape[1] - 1)
    ts_val = series[np.arange(idx.size), idx]
    o = np.where(wt[r] == 4, ts_val, c(x["inflow"])[r] + ts_val)
    cols = np.arange(series.shape[1])
    back = last_true((series >= 0) & (cols >= 1) & (cols <= idx[:, None]))
    extra = np.where(back >= 0, idx - back, np.maximum(idx - 1, 0))
    extra = np.where(in_window & (o < 0), extra, 0)
    total += int(r.sum() + item * use.sum() + 4 * test.sum()
                 + item * (advance.sum() + in_window.sum() + extra.sum()))
    walks["rfc"] = float((1 + extra)[in_window].mean()) \
        if in_window.any() else 0.0

    g = wt == 6
    gl_time = c(rd.gl_obs_time)[g]
    pick = last_true(now - gl_time >= 0)
    reads = np.where(pick >= 0, gl_time.shape[1] - pick, gl_time.shape[1])
    total += item * int(2 * g.sum() + reads.sum())
    walks["great lakes"] = float(reads.mean()) if reads.size else 0.0
    return total, walks


def phase_levelpool_da(device, dev: dict, n_res: int, n_nodes: int) -> dict:
    """Phase 14: kernel L1's DA form against the block it replaces, on the
    card (the module docstring)."""
    import torch
    import reservoir_da_lanes as rdl
    from troute_torch.ops import levelpool_cuda
    smi = dev["smi"]
    max_abs = 0.0
    launches = 0

    def counts():
        return levelpool_cuda.LAUNCHES, levelpool_cuda.DA_LAUNCHES

    def expect(want, what):
        if counts() != want:
            raise AssertionError(f"phase 14: {what}: L1 launched "
                                 f"{counts()} (all, DA form), expected "
                                 f"{want}")

    for dtype in (torch.float32, torch.float64):
        x = _ana_lakes(device, dtype, n_res, n_nodes, seed=14)
        H, inflow, p, rd, st = (x[k] for k in ("H", "inflow", "p", "res_da",
                                              "states"))
        rows, quc, q, d = (x[k] for k in ("rows", "quc", "q", "d"))
        now, month = x["now"], x["month_i"]
        kept = [[f.clone() for f in s] for s in st]
        q_in, d_in = q.clone(), d.clone()
        levelpool_cuda.LAUNCHES = levelpool_cuda.DA_LAUNCHES = 0
        elev, st_rows = levelpool_cuda.levelpool_da_rows_cuda(
            H, quc, rows, DT, p, rd, st, now, month, into=(q_in, d_in))
        *lanes, st_lanes = levelpool_cuda.levelpool_da_step_cuda(
            H, inflow, DT, p, rd, st, now, month)
        expect((2, 2), f"{dtype} DA forms")
        # the plain block: L1 without DA, the plain dispatch, index_put
        lp_out, lp_elev, lake_in = levelpool_cuda.levelpool_rows_cuda(
            H, quc, rows, DT, p)
        out, w_elev, d_scat, *w_rows = rdl.plain_dispatch(
            rd, st, H, lake_in, lp_out, lp_elev, now, month, p, DT)
        lp_out, lp_elev = levelpool_cuda.levelpool_step_cuda(
            H, inflow, inflow, None, DT, p)
        w_lanes = rdl.plain_dispatch(rd, st, H, inflow, lp_out, lp_elev,
                                     now, month, p, DT)
        expect((4, 2), f"{dtype} DA forms and the plain blocks")
        l1_read(4, f"phase 14 {dtype}", 14)
        torch.cuda.synchronize()
        launches += 2
        pairs = {"rows": [(q_in, q.index_put((rows,), out)), (elev, w_elev),
                          (d_in, d.index_put((rows,), d_scat))],
                 "lanes": list(zip(lanes, w_lanes[:3]))}
        for form, got_st, want_st in (("rows", st_rows, w_rows),
                                      ("lanes", st_lanes, w_lanes[3:])):
            pairs[form] += [(g, w) for gs, ws in zip(got_st, want_st)
                            for g, w in zip(gs, ws)]
        pairs["caller's states"] = [(f, k) for s, ks in zip(st, kept)
                                    for f, k in zip(s, ks)]
        for form, ps in pairs.items():
            for k, (g, w) in enumerate(ps):
                if g.is_floating_point() and w.dtype == g.dtype:
                    max_abs = max(max_abs, float(
                        (g.nan_to_num(0.0) - w.nan_to_num(0.0)).abs().max()))
                if not rdl.same(g, w):
                    off = ~((g == w) | (torch.isnan(g) & torch.isnan(w))) \
                        if g.is_floating_point() else g != w
                    where = sorted(set(x["branch"][off.cpu().numpy()])) \
                        if g.shape == H.shape else "node rows"
                    raise AssertionError(
                        f"phase 14: L1's DA form {form} {dtype} output "
                        f"{k} ({g.dtype} {tuple(g.shape)}) differs from "
                        f"the plain block at {where}")
        kinds = {str(b): int((x["branch"] == b).sum())
                 for b in dict.fromkeys(x["branch"])}
        log(f"phase 14: L1's DA form vs L1 + typed_reservoir_dispatch + "
            f"index_put {dtype}, {n_res} lakes on {n_nodes} rows "
            f"({rd.hybrid_obs.shape[1]} persistence observations, "
            f"{rd.rfc_series.shape[1]} RFC values): row form (q, elevation, "
            f"d, nine DA states) and lane form (outflow, elevation, depth "
            f"column, nine DA states) bit for bit, the caller's states "
            f"untouched, launches (all, DA form) {counts()}; lakes by "
            f"branch {kinds}")

    # the short step's form, f32: device time, enqueue interval, bound
    x = _ana_lakes(device, torch.float32, n_res, n_nodes, seed=15)
    H, p, rd, st = (x[k] for k in ("H", "p", "res_da", "states"))
    rows, quc, q, d = (x[k] for k in ("rows", "quc", "q", "d"))
    now, month = x["now"], x["month_i"]

    def fused():
        levelpool_cuda.levelpool_da_rows_cuda(H, quc, rows, DT, p, rd, st,
                                              now, month, into=(q, d))

    def block():
        lp_out, lp_elev, lake_in = levelpool_cuda.levelpool_rows_cuda(
            H, quc, rows, DT, p)
        out, _, d_scat, *_ = rdl.plain_dispatch(
            rd, st, H, lake_in, lp_out, lp_elev, now, month, p, DT)
        q.index_put((rows,), out)
        d.index_put((rows,), d_scat)

    calls = {"fused": 200, "block": 20}
    reps = {"fused": 2000, "block": 50}
    levelpool_cuda.LAUNCHES = levelpool_cuda.DA_LAUNCHES = 0
    fused()             # packs the parameters and the DA inputs
    block()
    torch.cuda.synchronize()
    prof = {name: profile_window(lambda: [fn() for _ in range(calls[name])],
                                 host_ops=False)
            for name, fn in (("fused", fused), ("block", block))}
    enqueue = {name: cuda_ms(fn, reps=reps[name])
               for name, fn in (("fused", fused), ("block", block))}
    # each side: one call before the profile, the profiled calls, the
    # timed calls and cuda_ms's warm-up call
    n_fused = 2 + calls["fused"] + reps["fused"]
    expect((n_fused + 2 + calls["block"] + reps["block"], n_fused),
           "the timed calls")
    launches += n_fused
    l1_read(n_fused + 2 + calls["block"] + reps["block"],
            "phase 14's timed calls", 14)
    if prof["fused"]["busy_ms"] is None:
        ms = plain_ms = plain_kernels = None
    else:
        # one kernel a call; the profiler may drop an event of a run of
        # short kernels, so the time is over the kernels it traced
        traced = prof["fused"]["counts"]
        name = next(iter(traced), "")
        seen = traced.get(name, 0)
        if len(traced) != 1 or "levelpool_da" not in name \
                or not 0.99 * calls["fused"] <= seen <= calls["fused"]:
            raise AssertionError(f"phase 14: the profiled DA-form calls "
                                 f"traced {prof['fused']['counts']}")
        ms = prof["fused"]["by_name"][name] / seen
        plain_ms = sum(prof["block"]["by_name"].values()) / calls["block"]
        plain_kernels = prof["block"]["launches"] / calls["block"]
    n_bytes, walks = _da_bytes(x)
    bound_ms = 1e3 * n_bytes / HBM_BYTES_PER_S
    log(f"phase 14: f32 DA row form, {n_res} lakes: L1's DA form "
        f"{'not measured' if ms is None else f'{ms * 1e3:.2f} us'} of device "
        f"time a call (profiler, {calls['fused']} calls), the wrapper "
        f"enqueues one every {enqueue['fused'] * 1e3:.2f} us back to back "
        f"(CUDA events); the plain block "
        f"{'not measured' if plain_ms is None else f'{plain_ms * 1e3:.2f} us'}"
        f" of device time over {plain_kernels} operations a call, one every "
        f"{enqueue['block'] * 1e3:.2f} us back to back; bound "
        f"{bound_ms * 1e3:.3f} us ({n_bytes} B, {n_bytes / n_res:.1f} B a "
        f"lake, over {HBM_BYTES_PER_S / 1e12:.2f} TB/s); values read a "
        f"lake's walk, mean by kind {walks}  [{smi}]")
    res = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes", enqueue_ms=enqueue["fused"],
               plain_enqueue_ms=enqueue["block"], plain_kernels=plain_kernels,
               bytes_per_lake=n_bytes / n_res, walks=walks, max_abs=max_abs,
               launches=launches)
    log(f"phase 14: {json.dumps(res)}")
    return res


def regional_network(n: int, n_basins: int, seed: int):
    """A regional drainage network (``synthetic.regional_network``):
    ``n`` segments in ``n_basins`` basins of equal size, each wired by
    ``synthetic_conus``'s hop rule.  The CONUS generator's few giant
    basins are hundreds of thousands of levels deep (491,078 at full
    size), where a real basin of a million segments is about 4,000; a
    region of many basins is the level scan's realistic shape."""
    from troute_torch.synthetic import regional_network as generate
    return generate(n, n_basins, seed)


def _network(n: int, n_res: int, n_gage: int, seed: int, conn=None):
    """Post-order synthetic network (``conn`` = (ids, downstream ids), or
    CONUS statistics) with level-pool reservoirs and gages, as NumPy
    inputs for the engine."""
    from troute_torch import synthetic
    from troute_torch.network.topology import build_topology_postorder
    ids, down = synthetic.synthetic_conus(n=n) if conn is None else conn
    rng = np.random.default_rng(seed)
    has_up = np.zeros(n, bool)
    has_up[np.searchsorted(ids, down[down > 0])] = True
    nt = np.zeros(n, np.int8)
    nt[rng.choice(np.flatnonzero(has_up), n_res, replace=False)] = 1
    topo = build_topology_postorder(ids, down, node_type=nt)
    chan = synthetic.channel_params(n, rng)
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


def _route_args(device, dtype, case, nts: int, qts: int = 12,
                strict: bool = False, start: dict | None = None,
                levels: bool = False, **cfg_kw) -> tuple:
    """The engine's arguments for ``case`` on ``device``, from its initial
    state or from the tensors of ``start`` (q, depth, res_elev,
    lastobs_val, lastobs_time, copied to ``device``): short steps, strict
    fixed-point steps with the block skip on, or (``levels``) the level
    scan's network arrays and config."""
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
    net = engine.network_arrays_from_topology(topo, device=device,
                                              need_levels=levels)
    da = engine.GageDA(rows=t(gage["rows"], torch.int64), obs=t(gage["obs"]),
                       lastobs_val=t(s["lastobs_val"]),
                       lastobs_time=t(s["lastobs_time"]), decay_coeff=120.0)
    cfg_kw.setdefault("strict_block_skip", strict)
    cfg = engine.RoutingConfig(
        dt=DT, nts=nts, qts_subdivisions=qts,
        assume_short_ts=not (strict or levels), strict_iterative=strict,
        **cfg_kw)
    return (net, engine.ChannelParams.from_arrays(device=device, dtype=dtype,
                                                  **chan),
            LevelpoolParams(*[t(v) for v in lp]), cfg, t(s["q"]),
            t(s["depth"]), t(s["res_elev"]), t(qlat), da)


def _route(device, dtype, case, nts: int, qts: int = 12,
           strict: bool = False, start: dict | None = None,
           collect: bool = True, levels: bool = False, **cfg_kw):
    """``route_stepped`` (or with ``levels`` ``route()``) on
    ``_route_args``'s inputs; the outputs and final state by name."""
    import torch
    from troute_torch.routing import engine
    args = _route_args(device, dtype, case, nts, qts, strict, start, levels,
                       **cfg_kw)
    net = args[0]
    out = (engine.route(*args) if levels
           else engine.route_stepped(*args, collect=collect))
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
    if levels:
        res.update(mc_calls=out["mc_calls"], net=net)
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


def _f32_flips(case, card: dict, keys, got, want, ref64, nts: int):
    """Each f32 value past 5e-2 (card against CPU): where it lies (output,
    step, node row), its node's type (reservoir, gage, a gage's upstream
    or downstream neighbour, or plain), and which f32 run lies nearer the
    CPU's f64 run on it."""
    topo, gage_rows = case[0], np.asarray(case[7]["rows"])
    near_gage = set(topo.downstream[gage_rows].tolist())
    near_gage.update(topo.upstream[gage_rows].ravel().tolist())
    near_gage -= {-1}

    def kind(row):
        if topo.node_type[row] != 0:
            return "reservoir"
        if row in set(gage_rows.tolist()):
            return "gage"
        return "gage neighbour" if row in near_gage else "plain"

    ok = ~np.isnan(want)
    rel = np.where(ok, rel_diff(got, np.where(ok, want, 1.0)), 0.0)
    out, start = [], 0
    for k in keys:
        shape = tuple(card[k].shape)
        size = int(np.prod(shape))
        for i in np.flatnonzero(rel[start:start + size] > 5e-2):
            at = np.unravel_index(i, shape)
            step = int(at[0]) + 1 if k in ("fvd", "nudge") else nts
            if k == "fvd":
                node = kind(int(at[1]))
            elif k == "nudge" or k.startswith("lastobs"):
                node = "gage"
            elif k == "res_elev":
                node = "reservoir"
            else:
                node = kind(int(at[0]))
            j = start + i
            nearer = ("card" if abs(got[j] - ref64[j]) < abs(want[j]
                                                              - ref64[j])
                      else "cpu" if abs(got[j] - ref64[j])
                      > abs(want[j] - ref64[j]) else "tie")
            out.append(dict(output=k, at=[int(x) for x in at], step=step,
                            node=node, card=float(got[j]),
                            cpu=float(want[j]), f64=float(ref64[j]),
                            nearer=nearer))
        start += size
    return out


def phase_engine_card_vs_cpu(device, n: int, nts: int) -> None:
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    case = _network(n, n_res=max(n // 1000, 1), n_gage=max(n // 500, 1),
                    seed=5)
    ref64 = None
    for dtype in (torch.float64, torch.float32):
        before = mcc.LAUNCHES
        l1_reset()
        t0 = time.perf_counter()
        card = _route(device, dtype, case, nts)
        t_card = time.perf_counter() - t0
        l1_read(nts, f"phase 3 {dtype}", 3)
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
            ref64 = want
        else:
            flips = _f32_flips(case, card, keys, got, want, ref64, nts)
            tally = {}
            for f in flips:
                key = (f["node"], f["nearer"])
                tally[key] = tally.get(key, 0) + 1
            log(f"phase 3: f32 values past 5e-2 by node type and the run "
                f"nearer f64: "
                f"{ {f'{a}, {b} nearer': v for (a, b), v in tally.items()} }")
            for f in flips[:60]:
                log(f"phase 3: f32 past 5e-2: {json.dumps(f)}")
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


def main_path_windows(device, n: int, nts: int, smi: str) -> dict:
    """bench.py:410-480 of the JAX package, on the port: cold windows
    re-route the initial state, warm windows hand the state forward with
    fresh forcing; B1's launches counted."""
    import torch
    from troute_torch import synthetic
    from troute_torch.network.topology import build_topology
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.levelpool import LevelpoolParams
    from troute_torch.routing import engine

    f32 = torch.float32
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    ids, down = synthetic.synthetic_conus(n)
    topo = build_topology(ids, down)
    net = engine.network_arrays_from_topology(topo, device=device)
    chan = synthetic.channel_params(n, rng)
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
        f"remainder={int(net.uplan.rem_dst.shape[0])}, remainder layers "
        f"{remainder_layers(net.uplan)})")

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
    mcc.LAUNCHES = mcc.SKIP_LAUNCHES = 0
    l1_reset()
    out, first_s = window(q0, d0, qlats[0])
    cold = [window(q0, d0, qlats[0])[1] for _ in range(5)]
    q_w, d_w = out["state"].q, out["state"].depth
    warm = []
    for i in range(13):
        out, dt = window(q_w, d_w, qlats[(i + 1) % len(qlats)])
        q_w, d_w = out["state"].q, out["state"].depth
        if i >= 3:
            warm.append(dt)
    launches, skip_launches = mcc.LAUNCHES, mcc.SKIP_LAUNCHES
    windows = 1 + len(cold) + 13
    # the synthetic CONUS network of this phase has no lakes
    l1_read(windows * nts if net.res_rows.shape[0] else 0, "phase 4", 4)
    if launches != windows * nts or skip_launches != 0:
        raise AssertionError(f"{launches} B1 and {skip_launches} B2 launches "
                             f"for {windows} short-mode windows of {nts} "
                             f"steps")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    seg = n * nts
    log(f"phase 4: {launches} B1 launches = {nts} per window x {windows} "
        f"windows, {skip_launches} B2 launches; all outputs finite; peak "
        f"{peak_gb:.2f} GB")
    log(f"phase 4: first window {first_s:.3f} s; cold best "
        f"{min(cold):.4f} s median {statistics.median(cold):.4f} s -> "
        f"{seg / min(cold):.4e} seg-ts/s; warm best {min(warm):.4f} s "
        f"median {statistics.median(warm):.4f} s -> "
        f"{seg / min(warm):.4e} seg-ts/s  [{smi}]")
    return dict(launches=launches, skip_launches=skip_launches, cold=cold,
                warm=warm,
                setup=dict(net=net, cp=cp, lp=lp, cfg=cfg, qlats=qlats, q=q_w,
                           d=d_w, q0=q0, d0=d0))


def phase_main_path(device, dev: dict, n: int, nts: int,
                    baseline=None) -> dict:
    """The main path's windows (``main_path_windows``), then B1 on one warm
    step's inputs."""
    from troute_torch.ops import muskingum_cuda as mcc
    smi = dev["smi"]
    res = main_path_windows(device, n, nts, smi)
    ctx = res["setup"]
    net, cp = ctx["net"], ctx["cp"]
    args = warm_step_args(net, cp, ctx["q"], ctx["d"], ctx["qlats"][0][0])
    _, trips, evals, max_abs = b1_gate(args, "warm step", diag=False)
    q = args[2]
    up_ms = cuda_ms(lambda: net.uplan(q))
    log(f"phase 4: warm step, {net.uplan.n_pad} lanes f32: B1 vs plain bit "
        f"for bit, trips and evaluations equal, two calls identical; banded "
        f"upstream sum {up_ms:.3f} ms  [{smi}]")
    res.update(b1_numbers(dev, args, trips, evals, False,
                          "phase 4: warm step f32", smi, baseline),
               max_abs=max_abs)
    if baseline is not None:
        b1_window_turns(ctx, baseline, smi)
    return res


def b1_window_turns(ctx: dict, baseline, smi: str) -> None:
    """B1 and the baseline B1 on each step's inputs of one cold and one
    warm main-path window (captured from ``route_stepped``), in turns per
    step (baseline, B1, B1, baseline), outputs bit for bit; logs the sums
    over the window and the steps where B1 loses most."""
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.routing import engine
    real = engine.muskingum_cunge_cuda
    zeros1 = torch.zeros(1, dtype=torch.float32, device=ctx["q"].device)
    for name, start in (("cold", (ctx["q0"], ctx["d0"], ctx["qlats"][0])),
                        ("warm", (ctx["q"], ctx["d"], ctx["qlats"][1]))):
        steps = []

        def capture(*args, **kw):
            steps.append(([a.clone() for a in args[:13]],
                          kw.get("with_diagnostics", True)))
            return real(*args, **kw)

        engine.muskingum_cunge_cuda = capture
        try:
            engine.route_stepped(ctx["net"], ctx["cp"], ctx["lp"], ctx["cfg"],
                                 *start[:2], zeros1, start[2])
        finally:
            engine.muskingum_cunge_cuda = real
        rows = []
        for k, (a, diag) in enumerate(steps):
            if not all(torch.equal(g, w) for g, w in zip(
                    baseline(a, diag), mcc.muskingum_cunge_cuda(
                        *a, DT, with_diagnostics=diag))):
                raise AssertionError(f"{name} step {k}: baseline and B1 "
                                     "differ")
            def ours():
                return mcc.muskingum_cunge_cuda(*a, DT, with_diagnostics=diag)

            def base():
                return baseline(a, diag)

            t = [cuda_ms(f) for f in (base, ours, ours, base)]
            _, trips, evals = mcc.muskingum_cunge_cuda(*a, DT,
                                                       with_diagnostics=diag,
                                                       return_trips=True)
            st = trip_stats(trips, evals)
            rows.append((k, (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, st))
        base_ms = sum(r[1] for r in rows)
        b1_ms = sum(r[2] for r in rows)
        worst = sorted(rows, key=lambda r: r[1] - r[2])[:3]
        lane_evals = sum(r[3]["lane_evals"] for r in rows)
        log(f"phase 4: {name} window, {len(rows)} steps: B1 {b1_ms:.4f} ms, "
            f"baseline {base_ms:.4f} ms in all (per step, in turns); "
            f"{lane_evals} residual evaluations; SIMT efficiency of one "
            f"thread per lane, mean over steps, per warp "
            f"{statistics.mean(r[3]['simt'] for r in rows):.4f}, per "
            f"256-lane block {statistics.mean(r[3]['block'] for r in rows):.4f}"
            f"; B1's three worst steps against the baseline: "
            + "; ".join(f"step {k}: {b:.4f} against {a:.4f} ms, trips mean "
                        f"{st['mean']:.3f} max {st['max']}, SIMT efficiency "
                        f"per warp {st['simt']:.4f} per block {st['block']:.4f}"
                        for k, a, b, st in worst) + f"  [{smi}]")


_WINDOWS_LINE = re.compile(
    r"cold best ([\d.]+) s median ([\d.]+) s -> ([\d.e+]+) seg-ts/s; warm "
    r"best ([\d.]+) s median ([\d.]+) s -> ([\d.e+]+) seg-ts/s")
_STRICT_LINE = re.compile(
    r"phase 7: (skip off|skip on|accel off): best ([\d.]+) s median "
    r"([\d.]+) s -> ([\d.e+]+) seg-ts/s \(median ([\d.e+]+)\); sweeps per "
    r"step ([\d.]+)")
_REGION_LINE = re.compile(r"regional route_stepped: (.*)$", re.M)


def remainder_layers(uplan) -> int:
    """``index_add`` calls of one upstream sum's remainder: its layers
    (``upstream_plan.remainder_layers``), 1 for a plan added in one call
    (before the layers), 0 without remainder edges."""
    if not uplan.rem_dst.shape[0]:
        return 0
    return len(getattr(uplan, "rem_cuts", ())) + 1


def regional_steps(device, smi: str, nts: int = 24, reps: int = 5,
                   pairs: int = 10) -> None:
    """``route_stepped`` in short mode, f32, with gage nudging and level
    pools, on phase 9's regional network (the networks of phases 3, 9 and
    12 have remainder edges; phase 4's has none): ms per step, best and
    median of ``reps`` runs.  Where the plan adds its remainder in
    layers, also ``pairs`` pairs of runs with the layers and with the
    remainder in one ``index_add`` (the same terms, in any order on the
    card), alternating which runs first."""
    import torch
    from troute_torch.routing import engine
    case = _network(N_REGION, n_res=300, n_gage=300, seed=9,
                    conn=regional_network(N_REGION, N_BASINS, seed=9))
    args = _route_args(device, torch.float32, case, nts)
    engine.route_stepped(*args, collect=False)
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.route_stepped(*args, collect=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / nts)
    log(f"regional route_stepped: N={N_REGION}, remainder edges "
        f"{int(args[0].uplan.rem_dst.shape[0])}, remainder layers "
        f"{remainder_layers(args[0].uplan)}, short f32 {nts} steps: best "
        f"{min(ms):.3f} ms median {statistics.median(ms):.3f} ms per step  "
        f"[{smi}]")
    net = args[0]
    if remainder_layers(net.uplan) < 2:
        return
    runs = {"layers": args,
            "one": (net._replace(uplan=net.uplan._replace(rem_cuts=())),)
            + args[1:]}
    ms = {k: [] for k in runs}
    for i in range(pairs):
        for name in (("layers", "one") if i % 2 == 0 else ("one", "layers")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            engine.route_stepped(*runs[name], collect=False)
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3 / nts)
    wins = sum(a < b for a, b in zip(ms["layers"], ms["one"]))
    log(f"regional remainder pairs: {pairs} pairs, ms per step, layers "
        f"{[round(t, 3) for t in ms['layers']]} (median "
        f"{statistics.median(ms['layers']):.3f}), one index_add "
        f"{[round(t, 3) for t in ms['one']]} (median "
        f"{statistics.median(ms['one']):.3f}); the layers faster in {wins} "
        f"of {pairs} pairs  [{smi}]")


def turn_windows(device, n: int, nts: int, smi: str) -> None:
    """One turn of ``main_path_turns``, with whichever ``troute_torch`` is
    first on ``sys.path``: phase 4's windows, phase 7's strict windows
    from their warm state, and ``regional_steps``."""
    import troute_torch
    log(f"turn package: {Path(troute_torch.__file__).parent}")
    res = main_path_windows(device, n, nts, smi)
    strict_windows(device, res["setup"], smi)
    del res
    regional_steps(device, smi)


def main_path_turns(base: Path, n: int, nts: int, smi: str) -> None:
    """``turn_windows`` of this script on the package of the checkout
    ``base`` and on this checkout's, each in a process of its own, in
    turns: baseline, this, this, baseline.  Logs each turn's phase-4 cold
    and warm windows, phase-7 strict windows (best and median s,
    seg-ts/s) and ``regional_steps``."""
    base = base.resolve()
    for turn, (name, root) in enumerate((("baseline", base), ("this", ROOT),
                                         ("this", ROOT),
                                         ("baseline", base))):
        code = (f"import sys; sys.path[:0] = [{str(root)!r}]; "
                f"import importlib.util as u; s = u.spec_from_file_location("
                f"'chip_smoke', {str(ROOT / 'chip_smoke.py')!r}); m = "
                f"u.module_from_spec(s); sys.modules['chip_smoke'] = m; "
                f"s.loader.exec_module(m); m.turn_windows('cuda:0', {n}, "
                f"{nts}, {smi!r})")
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=600)
        m = _WINDOWS_LINE.search(proc.stdout)
        strict = _STRICT_LINE.findall(proc.stdout)
        region = _REGION_LINE.search(proc.stdout)
        if proc.returncode != 0 or m is None or len(strict) != 3 \
                or region is None or f"turn package: {root}" not in \
                proc.stdout:
            raise AssertionError(f"main-path turn {turn} ({name}) failed: "
                                 f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        cb, cm, cr, wb, wm, wr = m.groups()
        log(f"phase 4 turns: {turn} {name} ({root}): cold best {cb} s median "
            f"{cm} s -> {cr} seg-ts/s (median "
            f"{n * nts / float(cm):.4e}); warm best {wb} s median {wm} s -> "
            f"{wr} seg-ts/s (median {n * nts / float(wm):.4e})  [{smi}]")
        log(f"phase 7 turns: {turn} {name}: " + "; ".join(
            f"{k} best {b} s median {md} s -> {r} seg-ts/s (median {mr}), "
            f"sweeps per step {sw}" for k, b, md, r, mr, sw in strict)
            + f"  [{smi}]")
        log(f"regional turns: {turn} {name}: {region.group(1)}")


def warm_step_args(net, cp, q, d, qlat):
    """B1's inputs for one short step from state (q, d) and lateral inflow
    ``qlat`` [N], as ``_one_short_step`` passes them."""
    from troute_torch.routing import engine
    args = [engine._upstream_sum_stepped(q, net.upstream, net.uplan)] * 2 \
        + [q, qlat, *cp, d]
    return [a.contiguous() for a in args]


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


def _state_dict(st) -> dict:
    return dict(q=st.q, depth=st.depth, res_elev=st.res_elev,
                lastobs_val=st.lastobs_val, lastobs_time=st.lastobs_time)


def _run_values(run: dict) -> np.ndarray:
    """Every output value of an engine run (fvd, nudge, final state) as
    one vector."""
    keys = ("fvd", "nudge", "q", "depth", "res_elev", "lastobs_val",
            "lastobs_time")
    return np.concatenate([run[k].detach().cpu().numpy().ravel()
                           for k in keys])


def phase_strict_card_vs_cpu(device, n: int, nts: int) -> None:
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    case = _network(n, n_res=n // 1000, n_gage=n // 500, seed=5)
    for dtype in (torch.float64, torch.float32):
        start = _state_dict(_warm_state(device, dtype, case))
        strict = dict(nts=nts, qts=3, strict=True, start=start)
        mcc.LAUNCHES = mcc.SKIP_LAUNCHES = 0
        l1_reset()
        t0 = time.perf_counter()
        card = _route(device, dtype, case, **strict)
        t_card = time.perf_counter() - t0
        calls = card["strict_mc_calls"]
        # each Jacobi sweep is one short step: one MC and one L1 launch
        l1_read(calls["mc_secant"] + calls["mc_secant_skip"],
                f"phase 6 {dtype}", 6)
        launched = {"mc_secant": mcc.LAUNCHES,
                    "mc_secant_skip": mcc.SKIP_LAUNCHES}
        if launched != calls or not calls["mc_secant_skip"]:
            raise AssertionError(f"strict card run launched {launched}, its "
                                 f"sweeps call for {calls}")
        t0 = time.perf_counter()
        cpu = _route("cpu", dtype, case, **strict)
        t_cpu = time.perf_counter() - t0
        got, want = _run_values(card), _run_values(cpu)
        if not np.isfinite(got[~np.isnan(want)]).all():
            raise AssertionError("non-finite strict output on the card")
        if dtype == torch.float64:
            # a chunk boundary that falls on the other side of the
            # tolerance moves the committed iterate by O(strict_tol)
            st = check_f64_network(got, want, "strict f64", atol=1e-8)
            bar = (f"rtol 1e-9 / atol 1e-8 (10 strict_tol) off at "
                   f"{st['off']} of {st['n']} values, max rel {st['max']:.3g}")
        else:
            bar = check_strict_f32(got, want, "strict f32")
        log(f"phase 6: strict route_stepped {dtype} n={n} nts={nts}, card vs "
            f"cpu: {bar}; sweeps card {card['strict_sweeps']} cpu "
            f"{cpu['strict_sweeps']}; launches {launched}; card "
            f"{t_card:.2f} s, cpu {t_cpu:.2f} s")


def profile_window(fn, host_ops: bool = True) -> dict:
    """Device busy time of one call of ``fn`` under ``torch.profiler``: the
    union of the kernel, memcpy and memset intervals of its trace, and the
    kernels that take most of it.  Busy ms is None when the profiler saw no
    device activity (it then measured nothing).  ``host_ops`` False traces
    the device alone (no CPU operator events), for calls of several
    hundred thousand kernels."""
    import os
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    spans, by_name, counts = [], {}, {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            name = e.get("name", "?")[:60]
            by_name[name] = by_name.get(name, 0.0) + float(e["dur"])
            counts[name] = counts.get(name, 0) + 1
    if not spans:
        return dict(busy_ms=None, launches=0, top=[], by_name={},
                    counts={})
    busy, end = 0.0, -np.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(busy_ms=busy / 1e3, launches=len(spans),
                top=[(k, round(v / 1e3, 3)) for k, v in top],
                by_name={k: v / 1e3 for k, v in by_name.items()},
                counts=counts)


def strict_windows(device, ctx: dict, smi: str) -> dict:
    """bench.py:482-515 and benchmarks/bench_strict_skip.py on the port:
    12-step strict windows from phase 4's warm state, block skip off and
    on (accelerator "auto", on), and the plain Jacobi sweeps (accelerator
    off) beside them, in interleaved turns, the state handed forward.
    Returns the launches, the times and ``window(name, qlat)``."""
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
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
    return dict(launched=launched, times=times, window=window)


def phase_strict_main_path(device, dev: dict, ctx: dict,
                           baseline=None) -> dict:
    """``strict_windows``, the device's idle share of one window of each
    form, and B2 on one captured skip sweep against its plain version."""
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.muskingum import solve_block_skip
    from troute_torch.routing import engine

    smi = dev["smi"]
    sw = strict_windows(device, ctx, smi)
    launched, times, window = sw["launched"], sw["times"], sw["window"]

    # the device's idle share: busy time of one profiled window against
    # the median unprofiled window (the profiler inflates the host side)
    for name in times:
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
    # the plain version's gate call was its warm-up
    p_ms = cuda_ms(lambda: solve_block_skip(*args, dt=DT, ran=ran,
                                            prev=kw["prev"]),
                   reps=1, warm_up=False)
    b1_ms = cuda_ms(lambda: mcc.muskingum_cunge_cuda(
        *args, DT, with_diagnostics=diag), reps=20)
    # B2's bound: the solved lanes' evaluations (B1's on the same inputs),
    # 13 inputs read on solved lanes and `prev` read on the others, every
    # output written once, one flag per block
    _, trips, evals = mcc.muskingum_cunge_cuda(
        *args, DT, with_diagnostics=diag, return_trips=True)
    st = trip_stats(trips[ran], evals[ran])
    n_out, n_ran = (6 if diag else 3), int(ran.sum())
    n_lanes = int(args[0].shape[0])
    bound = kernel_bound(dev, 4 * (13 * n_ran + n_out * (n_lanes - n_ran)
                                   + n_out * n_lanes
                                   + mcc.block_flags(ran).numel()),
                         st["lane_evals"])
    base_ms = []
    if baseline is not None:
        # the baseline's B2 on the same sweep, in turns with this one
        flags = mcc.block_flags(kw["active_rows"]).to(torch.int32)

        def base():
            return baseline.skip(args, diag, kw["prev"], flags)

        def ours():
            return mcc.muskingum_cunge_cuda(*args, DT, **kw)

        if not all(torch.equal(g, w) for g, w in zip(base(), ours())):
            raise AssertionError("captured skip sweep: baseline B2 and B2 "
                                 "differ")
        turns = [cuda_ms(f, reps=20) for f in (base, ours, ours, base)]
        base_ms = [turns[0], turns[3]]
        log(f"phase 7: the same sweep in turns (baseline B2, B2, B2, "
            f"baseline B2): {' / '.join(f'{t:.4f}' for t in turns)} ms, bit "
            f"for bit  [{smi}]")
    # the slowest solved lane alone through B2: the floor that no
    # scheduling of the sweep removes
    i = int(torch.where(ran, trips, -1).argmax())
    one = [a[i:i + 1].contiguous() for a in args]
    one_kw = dict(with_diagnostics=diag,
                  active_rows=torch.ones(1, dtype=torch.bool, device=device),
                  prev=type(kw["prev"])(*[p[i:i + 1].contiguous()
                                          for p in kw["prev"]]))
    floor_ms = cuda_ms(lambda: mcc.muskingum_cunge_cuda(*one, DT, **one_kw),
                       reps=20)
    log(f"phase 7: one skip sweep, {n_lanes} lanes f32, {blocks:.4f} of "
        f"blocks active: B2 {b2_ms:.4f} ms, plain {p_ms:.3f} ms, B1 "
        f"{b1_ms:.4f} ms; bit for bit (max abs {max_abs:.3g}); solved lanes' "
        f"trips mean {st['mean']:.4f} max {st['max']}, evaluations mean "
        f"{st['evals_mean']:.4f} ({st['lane_evals']} in all); bound "
        f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: bytes "
        f"{bound['bytes_ms']:.4f}, issue {bound['issue_ms']:.4f}, MUFU "
        f"{bound['mufu_ms']:.4f} ms); slowest solved lane alone "
        f"{floor_ms:.4f} ms ({st['max']} trips, at {i / n_lanes:.3f} of the "
        f"lane range, so claimed that far into the call)  [{smi}]")
    return dict(launches=launched, max_abs=max_abs, ms=b2_ms, plain_ms=p_ms,
                b1_ms=b1_ms, active_blocks=blocks, floor_ms=floor_ms,
                baseline_ms=base_ms,
                trips_mean=st["mean"], trips_max=st["max"],
                evals_mean=st["evals_mean"], **bound)



def _cli_domain(base: Path, n: int, out_kinds: tuple,
                n_basins: int | None = None) -> dict:
    """A command-line case under ``base``: the synthetic CONUS network of
    ``n`` flowpaths (in ``n_basins`` basins of the CONUS size skew, by
    default CONUS's count scaled to ``n``; with ``n_basins`` given, basins
    of equal size, ``regional_network``) as a HYFeatures geopackage with
    about n // 500
    level-pool lakes and n // 350 gages, four hourly NEXOUT CSV files (2 run sets of
    24 steps at dt 300 s, qts 12) and ``cfg.yaml`` (short mode, lite
    restart, CSV and, with "parquet" in ``out_kinds``, parquet output of
    1,000 segments).  Returns the control file as a dict, the ids, the
    channel parameters and the seconds it took."""
    import yaml
    from troute_torch import synthetic
    t0 = time.perf_counter()
    base.mkdir(parents=True)
    (base / "forcing").mkdir()
    ids, down = (synthetic.synthetic_conus(
        n, n_basins=max(synthetic.CONUS_BASINS * n // N_CONUS, 12))
        if n_basins is None else regional_network(n, n_basins, seed=1))
    rng = np.random.default_rng(1)
    chan = synthetic.channel_params(n, rng)
    inner = ids[np.isin(ids, down) & (down > 0)]
    lake_segs = rng.choice(inner, n // 500, replace=False)
    # a lake that drains straight into another lake has no outlet segment
    lake_segs = lake_segs[~np.isin(down[lake_segs - 1], lake_segs)]
    lakes = {int(n + 1 + k): (int(seg), [a, 12.0, 1.2, 0.1, 8.0, 0.4, 11.0,
                                         12.0, 0.9])
             for k, (seg, a) in enumerate(zip(
                 lake_segs, rng.uniform(1.0, 3.0, lake_segs.size)))}
    gage_segs = rng.choice(np.setdiff1d(ids, lake_segs), n // 350,
                           replace=False)
    gages = {int(seg): f"{k + 1:08d}" for k, seg in enumerate(gage_segs)}
    synthetic.write_hyfeatures_geopackage(base / "domain.gpkg", ids, down,
                                          chan, lakes, gages)
    for k in range(4):
        synthetic.write_nexout_csv(
            base / "forcing" / f"20210823{13 + k}00NEXOUT.csv", ids,
            rng.uniform(0.01, 0.2, n))
    segments = [int(i) for i in rng.choice(ids, 1000, replace=False)]
    out = {"csv_output": {"csv_output_folder": "out",
                          "csv_output_segments": segments},
           "lite_restart": {"lite_restart_output_directory": "restart"}}
    if "parquet" in out_kinds:
        out["parquet_output"] = {"parquet_output_folder": "out",
                                 "parquet_output_segments": segments}
    cfg = {
        "log_parameters": {"showtiming": False, "log_level": "INFO"},
        "network_topology_parameters": {
            "supernetwork_parameters": {"geo_file_path": "domain.gpkg"},
            "waterbody_parameters": {
                "break_network_at_waterbodies": True,
                "level_pool": {"level_pool_waterbody_parameter_file_path":
                               "domain.gpkg"}}},
        "compute_parameters": {
            "compute_kernel": "auto", "assume_short_ts": True,
            "restart_parameters": {"start_datetime": "2021-08-23_13:00"},
            "forcing_parameters": {
                "dt": DT, "qts_subdivisions": 12, "nts": 48,
                "max_loop_size": 2, "nexus_input_folder": "forcing",
                "qlat_input_folder": "forcing"},
            "data_assimilation_parameters": {}},
        "output_parameters": out}
    with open(base / "cfg.yaml", "w") as f:
        yaml.safe_dump(cfg, f)
    return dict(cfg=cfg, ids=ids, chan=chan, lakes=lakes, gages=gages,
                segments=segments, seconds=time.perf_counter() - t0)


def _cli_run(base: Path, cfg: dict, name: str, *flags) -> dict:
    """``main_v04`` on ``cfg`` written as ``base/name``; beside the result,
    B1's and B2's launches of that run and the MC calls that the engine
    itself counted in strict mode (``strict_mc_calls`` of ``route_stepped``
    and ``mc_calls`` of ``route()``, summed over the run sets; zeros in
    short mode)."""
    import yaml
    from troute_torch import cli
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.routing import engine
    with open(base / name, "w") as f:
        yaml.safe_dump(cfg, f)
    real = engine.route_stepped, engine.route
    calls = {"mc_secant": 0, "mc_secant_skip": 0}

    def counted(fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            for k, v in out.get("strict_mc_calls", {}).items():
                calls[k] += v
            calls["mc_secant"] += out.get("mc_calls", 0)
            return out
        return run

    mcc.LAUNCHES = mcc.SKIP_LAUNCHES = 0
    l1_reset()
    engine.route_stepped, engine.route = (counted(f) for f in real)
    try:
        res = cli.main_v04(["-f", str(base / name), *flags])
    finally:
        engine.route_stepped, engine.route = real
    res["launches"] = {"mc_secant": mcc.LAUNCHES,
                       "mc_secant_skip": mcc.SKIP_LAUNCHES}
    res["strict_mc_calls"] = calls
    return res


def _cli_l1(res: dict, case: dict, what: str, phase: int) -> None:
    """A short or strict (Jacobi) command's L1 launches, read right after
    ``_cli_run``: one a short step or sweep, as B1 and B2 together, when
    the domain has lakes."""
    l1_read(sum(res["launches"].values()) if len(case["lakes"]) else 0,
            what, phase)


def _cli_strict(base: Path, case: dict, nts: int, *flags) -> dict:
    """``case``'s control file with ``strict_iterative`` and
    ``strict_block_skip`` on, ``nts`` steps in one run set from the 15:00
    lite restart that the short run of ``case`` wrote, no output files.  On
    the card, B1's and B2's launches must equal the engine's own MC calls
    and B2 must have run."""
    import copy
    strict = copy.deepcopy(case["cfg"])
    comp = strict["compute_parameters"]
    comp.update(assume_short_ts=False, strict_iterative=True,
                strict_block_skip=True)
    comp["restart_parameters"] = {
        "start_datetime": "2021-08-23_15:00",
        "lite_channel_restart_file": "restart/channel_restart_202108231500",
        "lite_waterbody_restart_file":
            "restart/waterbody_restart_202108231500"}
    comp["forcing_parameters"].update(nts=nts, max_loop_size=1)
    strict["output_parameters"] = {}
    res = _cli_run(base, strict, "strict.yaml", *flags)
    _cli_l1(res, case, f"phase 8 strict {flags}", 8)
    n = case["ids"].size
    if res["fvd"].shape != (nts, n, 3) or not np.isfinite(res["fvd"]).all():
        raise AssertionError(f"phase 8 strict {flags}: fvd "
                             f"{res['fvd'].shape} or not finite")
    want = ({"mc_secant": 0, "mc_secant_skip": 0} if "--cpu" in flags
            else res["strict_mc_calls"])
    if res["launches"] != want or not res["strict_mc_calls"]["mc_secant_skip"]:
        raise AssertionError(f"phase 8 strict {flags}: launched "
                             f"{res['launches']}, the engine's MC calls "
                             f"{res['strict_mc_calls']}")
    return res


def _cli_check_outputs(base: Path, case: dict, res: dict, what: str) -> None:
    """Finite outputs of the expected shape; every written file exists;
    the CSV and parquet subsets and the lite restarts read back as the
    returned flows and state."""
    import pandas as pd
    from troute_torch.io.restart import read_lite_restart
    fvd, n = res["fvd"], res["built"].n_nodes
    if fvd.shape != (48, n, 3) or n != case["ids"].size \
            or not np.isfinite(fvd).all():
        raise AssertionError(f"{what}: fvd {fvd.shape}, finite "
                             f"{bool(np.isfinite(fvd).all())}")
    if not (fvd[-1, :, 0] > 0).mean() > 0.99:
        raise AssertionError(f"{what}: flows did not reach the network")
    names = sorted(p.name for p in res["written"])
    want = sorted(["flowveldepth_202108231300.csv"]
                  + ["troute_output_202108231300.parquet"]
                  * ("parquet_output" in case["cfg"]["output_parameters"])
                  + [f"{k}_restart_20210823{h}00"
                     for k in ("channel", "waterbody") for h in (15, 17)])
    if names != want or not all(p.exists() for p in res["written"]):
        raise AssertionError(f"{what}: written {names}, expected {want}")
    keep = np.isin(res["ids"], case["segments"])
    sub = fvd[:, keep].transpose(1, 0, 2).reshape(int(keep.sum()), -1)
    # pyarrow writes one header line, the pandas writer two
    with_pyarrow = "parquet_output" in case["cfg"]["output_parameters"]
    csv = pd.read_csv(base / "out" / "flowveldepth_202108231300.csv",
                      index_col=0, header=0 if with_pyarrow else [0, 1])
    if list(csv.index) != list(res["ids"][keep]) or not np.allclose(
            csv.to_numpy(), sub, rtol=1e-6, atol=1e-9):
        raise AssertionError(f"{what}: the CSV does not read back")
    if "parquet_output" in case["cfg"]["output_parameters"]:
        pq = pd.read_parquet(base / "out"
                             / "troute_output_202108231300.parquet")
        if list(pq.index) != list(res["ids"][keep]) \
                or not np.array_equal(pq.to_numpy(), sub):
            raise AssertionError(f"{what}: the parquet does not read back")
    rows = res["built"].topo.reservoir_rows
    for stamp, q, d in (("1500", fvd[23, :, 0], fvd[23, :, 2]),
                        ("1700", res["final_state"][0],
                         res["final_state"][1])):
        ch = read_lite_restart(base / "restart"
                               / f"channel_restart_20210823{stamp}")
        wb = read_lite_restart(base / "restart"
                               / f"waterbody_restart_20210823{stamp}")
        if not (np.array_equal(ch.index, res["built"].topo.ids)
                and np.array_equal(ch["qd0"].to_numpy(), q)
                and np.array_equal(ch["h0"].to_numpy(), d)
                and np.array_equal(wb["qd0"].to_numpy(), q[rows])):
            raise AssertionError(f"{what}: restart {stamp} does not read "
                                 "back as the routed state")
    if rows.size != len(case["lakes"]) \
            or res["built"].gage_rows.size != len(case["gages"]):
        raise AssertionError(f"{what}: {rows.size} lakes, "
                             f"{res['built'].gage_rows.size} gages")


def phase_cli(dev: dict, n_full: int, n_small: int, n_strict: int) -> dict:
    """The command line on the card (see the module docstring, phase 8)."""
    import copy
    import logging
    import tempfile
    smi = dev["smi"]
    kinds = ("csv", "parquet") if dev["pyarrow"] else ("csv",)
    stages = []

    class Stages(logging.Handler):
        def emit(self, record):
            if "network stages" in record.getMessage():
                stages.append(record.getMessage())

    handler = Stages(level=logging.INFO)
    blog = logging.getLogger("troute_torch.network.builder")
    blog.addHandler(handler)
    blog.setLevel(logging.INFO)
    launches = {"mc_secant": 0, "mc_secant_skip": 0}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the full-size command ----
        base = Path(tmp) / "conus"
        case = _cli_domain(base, n_full, kinds)
        log(f"phase 8: wrote the {n_full}-flowpath case ({len(case['lakes'])} "
            f"lakes, {len(case['gages'])} gages, geopackage "
            f"{(base / 'domain.gpkg').stat().st_size / 1e6:.0f} MB, 4 NEXOUT "
            f"files) in {case['seconds']:.1f} s; output {kinds}")
        res = _cli_run(base, case["cfg"], "cfg.yaml")
        _cli_l1(res, case, "phase 8 full size", 8)
        _cli_check_outputs(base, case, res, "phase 8 full size")
        if res["launches"] != {"mc_secant": 48, "mc_secant_skip": 0}:
            raise AssertionError(f"phase 8: launches {res['launches']} for "
                                 "48 short steps")
        launches["mc_secant"] += res["launches"]["mc_secant"]
        tt, seg = res["task_times"], n_full * 48
        log(f"phase 8: python -m troute_torch -f cfg.yaml, N={n_full}, 2 run "
            f"sets x 24 steps, f32, short mode: task_times "
            f"{ {k: round(v, 3) for k, v in tt.items()} }; "
            f"{stages[-1] if stages else ''}; route part "
            f"{seg / tt['route_time']:.4e} seg-ts/s, whole command "
            f"{seg / tt['total_time']:.4e} seg-ts/s; B1 launches 48 = steps; "
            f"outputs finite, CSV{' and parquet' * dev['pyarrow']} subsets "
            f"and lite restarts read back  [{smi}]")
        full = dict(task_times=dict(tt), stages=stages[-1] if stages else "",
                    route_seg_ts_s=seg / tt["route_time"],
                    command_seg_ts_s=seg / tt["total_time"],
                    case_seconds=case["seconds"])
        del res

        # ---- the same control file at n_small: card against --cpu ----
        base = Path(tmp) / "small"
        case = _cli_domain(base, n_small, kinds)
        card = _cli_run(base, case["cfg"], "cfg.yaml")
        _cli_l1(card, case, "phase 8 small, card", 8)
        _cli_check_outputs(base, case, card, "phase 8 small, card")
        launches["mc_secant"] += card["launches"]["mc_secant"]
        cpu = _cli_run(base, case["cfg"], "cfg.yaml", "--cpu")
        _cli_l1(cpu, case, "phase 8 small, --cpu", 8)
        if cpu["launches"] != {"mc_secant": 0, "mc_secant_skip": 0}:
            raise AssertionError("phase 8: --cpu launched a kernel")
        got = np.concatenate([card["fvd"].ravel(),
                              *[a.ravel() for a in card["final_state"]]])
        want = np.concatenate([cpu["fvd"].ravel(),
                               *[a.ravel() for a in cpu["final_state"]]])
        st = check_f32_bar(got, want, "phase 8 card vs --cpu", max_share=1e-5)
        log(f"phase 8: N={n_small}, the same control file on the card and "
            f"with --cpu: f32 bar: median {st['median']:.3g}, p95 "
            f"{st['p95']:.3g}, max {st['max']:.3g}, {st['over_5e_2']} of "
            f"{got.size} values past 5e-2; card task_times "
            f"{ {k: round(v, 3) for k, v in card['task_times'].items()} }, "
            f"--cpu route {cpu['task_times']['route_time']:.2f} s")
        # one run set of 48 steps against two of 24: the second set is
        # warm from the first, so the flows agree to the f32 bar (a cold
        # second set would start from zero flow).  Not bit for bit on the
        # card: the upstream sum's remainder edges go through index_add,
        # whose atomics add in an order that changes from run to run
        one = copy.deepcopy(case["cfg"])
        one["compute_parameters"]["forcing_parameters"]["max_loop_size"] = 4
        one["output_parameters"] = {}
        single = _cli_run(base, one, "one_set.yaml")
        _cli_l1(single, case, "phase 8 one run set", 8)
        launches["mc_secant"] += single["launches"]["mc_secant"]
        warm = check_f32_bar(card["fvd"].ravel(), single["fvd"].ravel(),
                             "phase 8 two run sets vs one", max_share=1e-5)
        same_bits = float((card["fvd"] == single["fvd"]).mean())
        # strict mode with the block skip, from the state after run set 1
        sres = _cli_strict(base, case, 12)
        for k in launches:
            launches[k] += sres["launches"][k]
        log(f"phase 8: two run sets against one of 48 steps (warm hand-off): "
            f"f32 bar, max rel {warm['max']:.3g}, {same_bits:.6f} of the "
            f"values the same bits; strict_iterative with strict_block_skip "
            f"under the command line, N={n_small}, 12 steps from the 15:00 "
            f"restart: launches {sres['launches']} = the engine's MC calls, "
            f"outputs finite, route {sres['task_times']['route_time']:.2f} s"
            f"  [{smi}]")
        del card, cpu, single

        # ---- strict under the command line, card against --cpu, at
        # n_strict (on the CPU every sweep solves every lane) ----
        base = Path(tmp) / "strict"
        case = _cli_domain(base, n_strict, kinds)
        short = _cli_run(base, case["cfg"], "cfg.yaml")
        _cli_l1(short, case, "phase 8 strict domain, short", 8)
        _cli_check_outputs(base, case, short, "phase 8 strict domain, short")
        launches["mc_secant"] += short["launches"]["mc_secant"]
        s_card = _cli_strict(base, case, 6)
        for k in launches:
            launches[k] += s_card["launches"][k]
        s_cpu = _cli_strict(base, case, 6, "--cpu")
        got = np.concatenate([s_card["fvd"].ravel(),
                              *[a.ravel() for a in s_card["final_state"]]])
        want = np.concatenate([s_cpu["fvd"].ravel(),
                               *[a.ravel() for a in s_cpu["final_state"]]])
        bar = check_strict_f32(got, want, "phase 8 strict card vs --cpu")
        log(f"phase 8: N={n_strict}, strict_iterative with strict_block_skip "
            f"under the command line, 6 steps from the 15:00 restart, on the "
            f"card and with --cpu: {bar}; launches {s_card['launches']} = "
            f"the engine's MC calls (--cpu: {s_cpu['strict_mc_calls']} calls, "
            f"no launch); route card "
            f"{s_card['task_times']['route_time']:.2f} s, --cpu "
            f"{s_cpu['task_times']['route_time']:.2f} s  [{smi}]")
    blog.removeHandler(handler)
    return dict(launches=launches, strict_launches=sres["launches"], **full)


def phase_level_scan(device, dev: dict, n: int, n_basins: int, nts: int,
                     nts_cpu: int, n_cli: int, cli_basins: int) -> dict:
    """``route()``'s level scan on the card (the module docstring, phase
    9).  The CPU halves run ``nts_cpu`` steps: on the host the plain MC
    solve of a level row costs ~20 ms whatever its width, so a step costs
    ~20 ms per level row."""
    import torch
    from troute_torch.ops import muskingum_cuda as mcc
    smi = dev["smi"]
    t0 = time.perf_counter()
    case = _network(n, n_res=300, n_gage=300, seed=9,
                    conn=regional_network(n, n_basins, seed=9))
    topo = case[0]
    widest = int(np.bincount(topo.level).max())
    log(f"phase 9: regional network, N={n} in {n_basins} basins, 300 "
        f"level-pool reservoirs, 300 gages: {topo.n_levels} levels, the "
        f"widest {widest} segments (setup {time.perf_counter() - t0:.1f} s)")
    out = dict(launches=0)
    starts = {}
    for dtype in (torch.float64, torch.float32):
        # a routed start, as production strict windows have (phase 6)
        starts[dtype] = _state_dict(_warm_state(device, dtype, case))
        start = starts[dtype]
        mcc.LAUNCHES = 0
        l1_reset()
        t0 = time.perf_counter()
        card = _route(device, dtype, case, nts, levels=True, start=start)
        t_card = time.perf_counter() - t0
        # one L1 launch per level row with lakes, the same rows each step
        l1_scan = l1_read(None, f"phase 9 {dtype}", 9)
        if l1_scan <= 0 or l1_scan % nts:
            raise AssertionError(f"phase 9: kernel L1 launched {l1_scan} "
                                 f"times in {nts} steps")
        rows = int(card["net"].level_nodes.shape[0])
        if not mcc.LAUNCHES == card["mc_calls"] == rows * nts:
            raise AssertionError(f"level scan: {mcc.LAUNCHES} B1 launches, "
                                 f"the engine counted {card['mc_calls']}, "
                                 f"{rows} rows x {nts} steps")
        fixed = _route(device, dtype, case, nts, strict=True, start=start,
                       strict_block_skip=False)
        got, fp = _run_values(card), _run_values(fixed)
        if not np.isfinite(got[~np.isnan(fp)]).all():
            raise AssertionError("non-finite level-scan output on the card")
        # the first nts_cpu steps, on the card and on the CPU
        mcc.LAUNCHES = 0
        l1_reset()
        short = _route(device, dtype, case, nts_cpu, levels=True,
                       start=start)
        l1_read(l1_scan // nts * nts_cpu, f"phase 9 {dtype}, short", 9)
        out["launches"] += mcc.LAUNCHES + rows * nts
        if mcc.LAUNCHES != rows * nts_cpu:
            raise AssertionError("the short level scan launched "
                                 f"{mcc.LAUNCHES} B1 kernels")
        t0 = time.perf_counter()
        cpu = _route("cpu", dtype, case, nts_cpu, levels=True, start=start)
        t_cpu = time.perf_counter() - t0
        got_s, want = _run_values(short), _run_values(cpu)
        if dtype == torch.float64:
            st = check_f64_network(got_s, want, "level scan f64")
            bar = f"rtol 1e-9 off at {st['off']} of {st['n']} values"
            st = check_f64_network(got, fp, "level scan vs fixed point f64",
                                   atol=1e-8)
            fp_bar = (f"rtol 1e-9 / atol 1e-8 off at {st['off']}, max rel "
                      f"{st['max']:.3g}")
        else:
            bar = check_strict_f32(got_s, want, "level scan f32")
            fp_bar = check_strict_f32(got, fp, "level scan vs fixed point")
        log(f"phase 9: route() level scan {dtype}, {nts} steps, qts 12, "
            f"from a routed state: {rows} rows, B1 launches {rows * nts} = "
            f"rows x steps = the engine's count, card {t_card:.2f} s; "
            f"against route_stepped's fixed point on the card: {fp_bar}; "
            f"the first {nts_cpu} steps, card vs cpu: {bar} (cpu "
            f"{t_cpu:.2f} s)")
        out["rows"] = rows
        del card, cpu, fixed, short
    # f32 timing of route() alone on prebuilt inputs: the level scan is
    # bound by launches from the host
    from troute_torch.routing import engine
    f32 = torch.float32
    args = _route_args(device, f32, case, nts, start=starts[f32],
                       levels=True)
    args6 = args[:3] + (args[3]._replace(nts=6),) + args[4:]
    mcc.LAUNCHES = 0
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        engine.route(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times[1:])
    prof = profile_window(lambda: engine.route(*args6))
    b1_n = sum(v for k, v in prof["counts"].items() if "mc_secant" in k)
    b1_ms = sum(v for k, v in prof["by_name"].items() if "mc_secant" in k)
    if b1_n != 6 * out["rows"] \
            or mcc.LAUNCHES != (2 * nts + 6) * out["rows"]:
        raise AssertionError(f"the timed runs launched {mcc.LAUNCHES} B1 "
                             f"kernels, the profiled run traced {b1_n}")
    out["launches"] += mcc.LAUNCHES
    wall6 = best * 6 / nts
    idle = (None if prof["busy_ms"] is None
            else 1.0 - prof["busy_ms"] / (wall6 * 1e3))
    out.update(ms_step=best / nts * 1e3, launches_step=prof["launches"] / 6,
               b1_ms_per_launch=b1_ms / b1_n, idle=idle)
    log(f"phase 9: level scan f32, {nts}-step route() calls: best "
        f"{best:.3f} s of {len(times) - 1} after a warm-up = "
        f"{out['ms_step']:.2f} ms per step, {n * nts / best:.4e} seg-ts/s; "
        f"one profiled 6-step call: {out['launches_step']:.0f} device "
        f"kernels per step ({out['rows']} of them B1), B1 "
        f"{out['b1_ms_per_launch'] * 1e3:.2f} us per level launch, device "
        f"busy {prof['busy_ms']:.1f} ms against {wall6 * 1e3:.0f} ms of an "
        f"unprofiled 6 steps (idle share {idle:.3f}); top {prof['top']}"
        f"  [{smi}]")
    cli = _cli_level_scan(dev, n_cli, cli_basins)
    out["launches"] += cli["cli_launches"]
    return out


def _cli_level_scan(dev: dict, n: int, n_basins: int) -> dict:
    """Phase 8's control file at ``n`` flowpaths in ``n_basins`` equal
    basins with the schema's default compute parameters (the level scan),
    6 steps from the 15:00 lite restart of a short run, on the card
    against ``--cpu``.  Phase 8's CONUS-skewed basins at 25,000 flowpaths
    are ~4,500 levels deep, which ``--cpu`` would route in ~10 minutes."""
    import copy
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp) / "levels"
        case = _cli_domain(base, n, ("csv",), n_basins=n_basins)
        _cli_run(base, case["cfg"], "cfg.yaml")
        cfg = copy.deepcopy(case["cfg"])
        comp = cfg["compute_parameters"]
        del comp["assume_short_ts"]
        comp["restart_parameters"] = {
            "start_datetime": "2021-08-23_15:00",
            "lite_channel_restart_file": "restart/channel_restart_202108231500",
            "lite_waterbody_restart_file":
                "restart/waterbody_restart_202108231500"}
        comp["forcing_parameters"].update(nts=6, max_loop_size=1)
        cfg["output_parameters"] = {}
        card = _cli_run(base, cfg, "levels.yaml")
        cpu = _cli_run(base, cfg, "levels.yaml", "--cpu")
    rows = card["strict_mc_calls"]["mc_secant"] // 6
    if card["launches"] != {"mc_secant": 6 * rows, "mc_secant_skip": 0} \
            or cpu["launches"]["mc_secant"] or not rows \
            or cpu["strict_mc_calls"]["mc_secant"] != 6 * rows:
        raise AssertionError(f"level scan under the command line: launched "
                             f"{card['launches']}, route() counted "
                             f"{card['strict_mc_calls']}")
    got = np.concatenate([card["fvd"].ravel(),
                          *[a.ravel() for a in card["final_state"]]])
    want = np.concatenate([cpu["fvd"].ravel(),
                           *[a.ravel() for a in cpu["final_state"]]])
    if card["fvd"].shape != (6, n, 3) or not np.isfinite(got).all():
        raise AssertionError("level scan under the command line: fvd "
                             f"{card['fvd'].shape} or not finite")
    bar = check_strict_f32(got, want, "phase 9 command line card vs --cpu")
    log(f"phase 9: python -m troute_torch -f levels.yaml (the schema's "
        f"default compute parameters: the level scan), N={n}, 6 steps from "
        f"the 15:00 restart: {rows} rows, B1 launches {card['launches']} = "
        f"rows x steps; card vs --cpu: {bar}; route card "
        f"{card['task_times']['route_time']:.2f} s, --cpu "
        f"{cpu['task_times']['route_time']:.2f} s  [{dev['smi']}]")
    return dict(cli_launches=card["launches"]["mc_secant"])


def check_share(got, want, what: str, rtol: float, share: float) -> dict:
    """rtol (atol 1e-12) on all but ``share`` of the values."""
    off = ~np.isclose(got, want, rtol=rtol, atol=1e-12)
    st = dict(off=int(off.sum()), n=int(off.size),
              max=float(rel_diff(got, want).max()))
    if st["off"] > share * st["n"]:
        raise AssertionError(f"{what}: {st['off']} of {st['n']} values past "
                             f"rtol {rtol}")
    return st


DIFFUSIVE_CONFIGS = (
    # name, dtype, corrector, uniform table entries, reaches (None: the
    # phase's R), routing steps of the timed run
    ("f32 jacobi uniform-128", "float32", "jacobi", 128, None, 12),
    ("f32 jacobi exact", "float32", "jacobi", None, None, 6),
    ("f64 jacobi exact", "float64", "jacobi", None, None, 6),
    ("f64 wavefront", "float64", "wavefront", None, 256, 6),
)


def _diffusive_run(device, dtype, mode, nel, r, c, nts, seed=2,
                   stats=None, t_steps=None):
    """``mainstem_tree(r, c, seed)`` built on ``device``, initialised, and
    routed ``t_steps`` (default ``nts``) steps of 300 s, saved each step;
    returns (domain, state, saves, seconds of the run)."""
    import torch
    from troute_torch.diffusive.domain import build_domain
    from troute_torch.diffusive.solver import (initialize_state,
                                               run_diffusive)
    from troute_torch.synthetic import mainstem_tree
    dom = build_domain(*mainstem_tree(r, c, seed=seed, nts=nts),
                       device=device, dtype=dtype, nel_uniform=nel)
    st0 = initialize_state(dom, torch.full((r, c), 30.0, dtype=dtype,
                                           device=device), DT / 10.0,
                           corrector_mode=mode)
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    st, saves = run_diffusive(dom, st0, (t_steps or nts) * DT, DT,
                              corrector_mode=mode, dispatch="device",
                              stats=stats)
    sync()
    return dom, st0, st, saves, time.perf_counter() - t0


def _diffusive_values(dom, saves) -> tuple[np.ndarray, np.ndarray]:
    """(q, y) of every save at the valid nodes, as float64 vectors."""
    v = dom.valid.cpu().numpy()
    q = np.concatenate([s[1].cpu().numpy()[v] for s in saves])
    y = np.concatenate([s[2].cpu().numpy()[v] for s in saves])
    return q.astype(np.float64), y.astype(np.float64)


def _diffusive_bars(card, cpu, dtype, what: str) -> str:
    """Card against CPU: f64 rtol 1e-9 on all but 1e-5 of the values; f32
    the f32 bar on q and surfaces within 1e-3 m; all finite."""
    (qg, yg), (qw, yw) = card, cpu
    if not (np.isfinite(qg).all() and np.isfinite(yg).all()):
        raise AssertionError(f"{what}: non-finite output on the card")
    if dtype == "float64":
        st = check_share(np.concatenate([qg, yg]), np.concatenate([qw, yw]),
                         what, rtol=1e-9, share=1e-5)
        return (f"rtol 1e-9 off at {st['off']} of {st['n']} values, max rel "
                f"{st['max']:.3g}")
    st = check_f32_bar(qg, qw, what)
    dy = float(np.abs(yg - yw).max())
    if dy > 1e-3:
        raise AssertionError(f"{what}: surfaces differ by {dy} m")
    return (f"q median {st['median']:.3g}, p95 {st['p95']:.3g}, max "
            f"{st['max']:.3g}; surfaces max {dy:.3g} m")


def _predictor_ms(dom, st) -> dict:
    """Device ms of one predictor call in each form on ``st`` (CUDA
    events, 5 calls back to back after a warm-up)."""
    import torch
    from troute_torch.diffusive.solver import predictor
    dt = torch.tensor(DT / 2.0, dtype=st.q.dtype, device=st.q.device)
    return {form: cuda_ms(lambda: predictor(dom, st, dt, st.t, form=form))
            for form in ("seq", "assoc")}


def phase_diffusive(device, dev: dict, r: int, c: int, nts: int,
                    r_cpu: int, nts_cmp: int, batch: int,
                    timed_steps: int = 0) -> dict:
    """The diffusive solver on the card (the module docstring, phase 10).
    Every configuration is bound by launches from the host, so a run
    costs about the same at R=256 as at R=2048 and its time follows the
    routing steps: the card-vs-CPU halves run ``nts_cmp`` steps, and each
    configuration is timed over one run of its steps
    (``DIFFUSIVE_CONFIGS``, or ``timed_steps`` for all) after a 2-step
    warm-up.  The first steps after the initialization take fewer
    sub-steps and sweeps than later ones, so seg-ts/s over 6 steps reads
    higher than over 24."""
    import torch
    smi = dev["smi"]
    out = {}
    for name, dt_name, mode, nel, r_cfg, n_timed in DIFFUSIVE_CONFIGS:
        n_timed = timed_steps or n_timed
        dtype = getattr(torch, dt_name)
        r_run = r_cfg or r
        # card against the port's CPU run on one domain of r_cmp reaches
        r_cmp = min(r_run, r_cpu)
        t0 = time.perf_counter()
        dom_c, _, _, saves_c, _ = _diffusive_run(device, dtype, mode, nel,
                                                 r_cmp, c, nts,
                                                 t_steps=nts_cmp)
        dom_h, _, _, saves_h, t_cpu = _diffusive_run(
            "cpu", dtype, mode, nel, r_cmp, c, nts, t_steps=nts_cmp)
        bar = _diffusive_bars(_diffusive_values(dom_c, saves_c),
                              _diffusive_values(dom_h, saves_h), dt_name,
                              f"phase 10 {name}")
        del dom_c, saves_c, dom_h, saves_h
        cmp_s = time.perf_counter() - t0
        # a 2-step warm-up, then the timed run at r_run reaches
        _diffusive_run(device, dtype, mode, nel, r_run, c, nts, t_steps=2)
        stats = {}
        dom, st0, st, saves, best = _diffusive_run(
            device, dtype, mode, nel, r_run, c, nts, stats=stats,
            t_steps=n_timed)
        valid = int(dom.valid.sum())
        q, y = _diffusive_values(dom, saves)
        if not (np.isfinite(q).all() and np.isfinite(y).all()):
            raise AssertionError(f"phase 10 {name}: non-finite output")
        pred = _predictor_ms(dom, st) if mode == "jacobi" else None
        # one profiled run of 1 routing step (its trace holds every launch)
        pstats = {}
        t0 = time.perf_counter()
        prof = profile_window(lambda: _diffusive_run(
            device, dtype, mode, nel, r_run, c, nts, stats=pstats,
            t_steps=1))
        prof_wall = time.perf_counter() - t0
        sub = stats["substeps"]
        sweeps = stats.get("sweeps", [0])
        res = dict(seg_ts_s=valid * n_timed / best, seconds=best,
                   steps=n_timed, substeps=sub,
                   sweeps_mean=float(np.mean(sweeps)),
                   sweeps_max=int(max(sweeps)),
                   newton_per_rtsafe=stats["newton_iters"]
                   / stats["rtsafe_calls"],
                   syncs_per_substep=stats["syncs"] / sub,
                   launches_per_substep=prof["launches"]
                   / max(pstats.get("substeps", 1), 1),
                   idle=(None if prof["busy_ms"] is None
                         else 1.0 - prof["busy_ms"] / (prof_wall * 1e3)),
                   predictor_ms=pred)
        out[name] = res
        log(f"phase 10: diffusive {name}, R={r_run} C={c} ({valid} valid "
            f"nodes), {n_timed} steps of {DT:.0f} s: {best:.3f} s after a "
            f"2-step warm-up -> {res['seg_ts_s']:.4e} seg-ts/s; {sub} "
            f"sub-steps, sweeps per sub-step mean {res['sweeps_mean']:.2f} "
            f"max {res['sweeps_max']}, {res['newton_per_rtsafe']:.2f} Newton "
            f"iterations per rtsafe call, {res['syncs_per_substep']:.1f} host "
            f"syncs and {res['launches_per_substep']:.0f} device kernels per "
            f"sub-step (kernels from one profiled 1-step run, idle share "
            f"{res['idle']:.3f}, wall {prof_wall:.2f} s); predictor ms on "
            f"the final state {pred}; card vs cpu at R={r_cmp}, {nts_cmp} "
            f"steps: {bar} (cpu run {t_cpu:.2f} s, both halves {cmp_s:.1f} "
            f"s)  [{smi}]")
        del dom, st0, st, saves
        torch.cuda.empty_cache()
    out["batched"] = _diffusive_batched(device, batch, r_cpu, c, 2, smi)
    return out


def _diffusive_batched(device, b: int, r: int, c: int, nts: int,
                       smi: str) -> dict:
    """``b`` trees of ``r`` reaches (f32, Jacobi, uniform-128 tables) as one
    [b, r, c] call on the card, against ``b`` solo calls (rtol 1e-12) and
    against the CPU."""
    import torch
    from troute_torch.diffusive.domain import (build_domain, stack_domains,
                                               stack_states)
    from troute_torch.diffusive.solver import (initialize_state,
                                               run_diffusive,
                                               run_diffusive_batched)
    from troute_torch.synthetic import mainstem_tree
    f32 = torch.float32
    out = {}
    for dev_ in (device, "cpu"):
        doms = [build_domain(*mainstem_tree(r, c, seed=10 + k, nts=nts),
                             device=dev_, dtype=f32, nel_uniform=128)
                for k in range(b)]
        sts = [initialize_state(d, torch.full((r, c), 30.0, dtype=f32,
                                              device=dev_), DT / 10.0,
                                corrector_mode="jacobi") for d in doms]
        bdom = stack_domains(doms)
        bst = stack_states(sts, doms, c, r)
        t0 = time.perf_counter()
        fin, saves = run_diffusive_batched(bdom, bst, nts * DT, DT,
                                           corrector_mode="jacobi")
        if dev_ != "cpu":
            torch.cuda.synchronize()
        out[dev_] = (bdom, fin, saves, time.perf_counter() - t0)
        if dev_ == device:
            t0 = time.perf_counter()
            solo = [run_diffusive(d, s, nts * DT, DT,
                                  corrector_mode="jacobi")
                    for d, s in zip(doms, sts)]
            torch.cuda.synchronize()
            t_solo = time.perf_counter() - t0
            for k, (fin_k, saves_k) in enumerate(solo):
                v = doms[k].valid.cpu().numpy()
                for sb, sk in zip(saves, saves_k):
                    for i in (1, 2):
                        g = sb[i][k].cpu().numpy()[v]
                        w = sk[i].cpu().numpy()[v]
                        if not np.allclose(g, w, rtol=1e-12, atol=0):
                            raise AssertionError(
                                f"batched tree {k} differs from its solo run")
    (bdom, _, saves_c, t_card), (_, _, saves_h, t_cpu) = (out[device],
                                                           out["cpu"])
    v = bdom.valid.cpu().numpy()
    card = (np.concatenate([s[1].cpu().numpy()[v] for s in saves_c]),
            np.concatenate([s[2].cpu().numpy()[v] for s in saves_c]))
    cpu = (np.concatenate([s[1].numpy()[v] for s in saves_h]),
           np.concatenate([s[2].numpy()[v] for s in saves_h]))
    bar = _diffusive_bars(tuple(a.astype(np.float64) for a in card),
                          tuple(a.astype(np.float64) for a in cpu),
                          "float32", "phase 10 batched")
    log(f"phase 10: batched [{b}, {r}, {c}] f32 Jacobi uniform-128, {nts} "
        f"steps: one call on the card {t_card:.2f} s, {b} solo calls "
        f"{t_solo:.2f} s: every "
        f"save of every tree equal to its solo run (rtol 1e-12); card vs "
        f"cpu: {bar} (cpu {t_cpu:.2f} s)  [{smi}]")
    return dict(card_s=t_card, solo_s=t_solo)


# ------------------------------------------------------------- phase 11

def _hybrid_case(device, n: int, n_basins: int, n_trees: int, tmp: Path):
    """``synthetic.hybrid_regional`` as phase 11 routes it: the
    ``HybridDomain`` (natural sections of every other tree from a parquet
    file, a coastal series at 2 tailwaters, staged as
    ``load_coastal_boundary`` stages it) and the MC network of the rest
    on ``device``, from the steady flows of its lateral inflow."""
    import torch
    from troute_torch import synthetic
    from troute_torch.network.topology import build_topology_postorder
    from troute_torch.ops.levelpool import LevelpoolParams
    from troute_torch.routing import engine
    from troute_torch.routing.hybrid import HybridDomain
    h = synthetic.hybrid_regional(n, n_basins, n_trees)
    rl = h["rl"]
    hyb = HybridDomain.from_routelink(rl, h["domain"])
    path = tmp / "topobathy.parquet"
    h["topobathy"].to_parquet(path)
    n_nat = hyb.load_topobathy(path)
    tw_reach = hyb.tailwater_reaches()
    db = np.full((hyb.n_reaches, 30), np.nan)
    for tw, series in h["coastal"].items():
        db[tw_reach[tw]] = series
    hyb.coastal_db, hyb.coastal_dt_db = db, 3600.0
    keep = ~np.isin(rl.ids, np.fromiter(hyb.mainstem_set, np.int64))
    topo = build_topology_postorder(rl.ids[keep], rl.downstream[keep])
    rows = np.searchsorted(rl.ids, topo.ids)
    rng = np.random.default_rng(23)
    qlat = rng.uniform(0.5, 1.5, topo.n_nodes)
    # the steady flows of that inflow (a routed start); post-order rows
    # come after every row upstream of them
    q0 = qlat.copy()
    for r in range(topo.n_nodes):
        d = topo.downstream[r]
        if d >= 0:
            q0[d] += q0[r]
    f32 = torch.float32
    mc = dict(
        net=engine.network_arrays_from_topology(topo, device=device),
        chan=engine.ChannelParams.from_arrays(
            device=device, dtype=f32,
            **{k: v[rows] for k, v in rl.channel.items()}),
        lp=LevelpoolParams(*[torch.ones(1, dtype=f32, device=device)] * 9),
        q0=q0.astype(np.float32), qlat=qlat.astype(np.float32))
    return dict(h=h, hyb=hyb, topo=topo, mc=mc, n_nat=n_nat)


def _hybrid_mc(device, case, nts: int):
    """MC of the hybrid network on ``device`` (f32, short steps, qts 12):
    (host fvd [nts, N, 3], seconds)."""
    import torch
    from troute_torch.routing import engine
    mc = case["mc"]
    t = lambda a: torch.as_tensor(a, device=device)
    cfg = engine.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=12,
                               assume_short_ts=True)
    t0 = time.perf_counter()
    out = engine.route_stepped(
        mc["net"], mc["chan"], mc["lp"], cfg, t(mc["q0"]),
        t(np.full_like(mc["q0"], 0.5)), t(np.zeros(1, np.float32)),
        t(mc["qlat"][None]))
    fvd = out["flowveldepth"].cpu().numpy()
    return fvd, time.perf_counter() - t0


def _mainstem_values(ms: dict) -> tuple[np.ndarray, np.ndarray]:
    d = ms["diffusive"]
    return d["q"].ravel(), d["depth"].ravel()


def _batch_vs_solo(device, hyb, fvd, ids, q0, dtype_s: str, nel,
                   steps: int) -> float:
    """The batched run of every tailwater tree against each tree's solo
    run over ``steps`` steps (Jacobi corrector): the largest relative
    difference over every save at every valid node."""
    import torch
    from troute_torch.diffusive.domain import stack_domains, stack_states
    from troute_torch.diffusive.solver import (initialize_state,
                                               run_diffusive,
                                               run_diffusive_batched)
    from troute_torch.network.builder import positions_of
    from troute_torch.routing.hybrid import mainstem_qlat
    rows, found = positions_of(ids, np.asarray(hyb.trib_segments))
    trib_q = np.zeros((steps + 1, rows.size))
    trib_q[0, found] = q0[rows[found]]
    trib_q[1:, found] = fvd[:steps, rows[found], 0]
    ms_ids, ql = mainstem_qlat(hyb, 1.0, 1)
    qlat_rows = {int(s): ql[:, k] for k, s in enumerate(ms_ids)}
    dtype = torch.float32 if dtype_s == "float32" else torch.float64
    doms = [hyb.build_diffusive_domain(
        qlat_rows, DT * 12, trib_q, DT, DT, device=device, dtype=dtype,
        reach_idx=g, nel_uniform=nel) for g in hyb.tailwater_groups()]
    sts = [initialize_state(d, torch.full(d.z.shape, 30.0, dtype=dtype,
                                          device=device), DT / 10.0)
           for d in doms]
    bdom = stack_domains(doms)
    bst = stack_states(sts, doms, bdom.n_cols, bdom.n_reaches)
    _, bsaves = run_diffusive_batched(bdom, bst, steps * DT, DT,
                                      corrector_mode="jacobi")
    worst = 0.0
    for k, (d, st) in enumerate(zip(doms, sts)):
        _, saves = run_diffusive(d, st, steps * DT, DT,
                                 corrector_mode="jacobi")
        v = d.valid.cpu().numpy()
        R, C = d.z.shape
        if len(saves) != len(bsaves):
            raise AssertionError(f"phase 11: tree {k}: {len(saves)} solo "
                                 f"saves, {len(bsaves)} batched")
        for sb, sk in zip(bsaves, saves):
            for i in (1, 2):
                g = sb[i][k, :R, -C:].cpu().numpy()[v]
                w = sk[i].cpu().numpy()[v]
                worst = max(worst, float(rel_diff(g, w).max()))
    return worst


def phase_hybrid(device, dev: dict, n: int, n_basins: int, n_trees: int,
                 nts: int, nts_cmp: int) -> dict:
    """Phase 11 (a): hybrid routing on the card (the module docstring)."""
    import tempfile
    import torch
    from troute_torch.config.schema import HybridParameters
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.routing.hybrid import HybridDomain, run_mainstem
    smi = dev["smi"]
    out = dict(launches=0)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        case = _hybrid_case(device, n, n_basins, n_trees, Path(tmp))
        hyb, topo, mc = case["hyb"], case["topo"], case["mc"]
        n_ms = len(hyb.mainstem_set)
        log(f"phase 11: hybrid network, N={n} in {n_basins} basins: "
            f"{n_trees} diffusive trees, {n_ms} mainstem segments in "
            f"{hyb.n_reaches} reaches "
            f"({[len(g) for g in hyb.tailwater_groups()]} per tree, widest "
            f"reach {max(map(len, hyb.reaches))} "
            f"segments), {len(hyb.trib_segments)} tributaries, natural "
            f"sections at {case['n_nat']} nodes (parquet), coastal series "
            f"at 2 tailwaters; MC network {topo.n_nodes} segments (setup "
            f"{time.perf_counter() - t0:.1f} s)")
        hp = HybridParameters()
        auto = hp.resolved_diffusive(torch.device(device).type)
        mcc.LAUNCHES = 0
        l1_reset()
        fvd, t_mc = _hybrid_mc(device, case, nts)
        l1_hybrid = l1_read(None, "phase 11 hybrid MC", 11)
        if l1_hybrid not in (0, nts):
            raise AssertionError(f"phase 11: kernel L1 launched {l1_hybrid} "
                                 f"times in {nts} short steps")
        if mcc.LAUNCHES != nts:
            raise AssertionError(f"phase 11: MC launched {mcc.LAUNCHES} B1 "
                                 f"kernels for {nts} steps")
        out["launches"] += mcc.LAUNCHES
        ids = np.asarray(topo.ids)
        stats = {}
        torch.cuda.synchronize()
        ms = run_mainstem(hyb, fvd, ids, mc["q0"], 1.0, DT, 12, hp, device,
                          stats=stats)
        t_diff = ms["seconds"]
        q, d = _mainstem_values(ms)
        if not (np.isfinite(q).all() and np.isfinite(d).all()
                and np.isfinite(ms["fvd"]).all()):
            raise AssertionError("phase 11: non-finite hybrid output")
        if ms["fvd"].shape != (nts, topo.n_nodes + n_ms, 3):
            raise AssertionError(f"phase 11: fvd shape {ms['fvd'].shape}")
        sweeps = stats.get("sweeps", [])
        out.update(mc_s=t_mc, diffusive_s=t_diff,
                   seg_ts_s=n_ms * nts / t_diff, substeps=stats["substeps"],
                   sweeps_per_substep=float(np.mean(sweeps)),
                   dtype=auto[0], nel=auto[1])
        log(f"phase 11: MC route_stepped f32 {nts} steps {t_mc:.3f} s ("
            f"{mcc.LAUNCHES} B1 launches = steps); run_mainstem "
            f"{auto[0]} nel {auto[1]} ('auto' on the card), {n_trees} "
            f"batch lanes: {t_diff:.2f} s, {out['seg_ts_s']:.4e} mainstem "
            f"seg-ts/s, {stats['substeps']} sub-steps, "
            f"{out['sweeps_per_substep']:.2f} sweeps per sub-step (max "
            f"{max(sweeps)}), {stats['newton_iters']} Newton iterations in "
            f"{stats['rtsafe_calls']} rtsafe calls, {stats['syncs']} host "
            f"syncs; q {q.min():.3g}..{q.max():.3g} m3/s, depth "
            f"{d.min():.3g}..{d.max():.3g} m  [{smi}]")
        # one profiled 1-step run against an unprofiled one
        cut = fvd[:1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st1 = {}
        run_mainstem(hyb, cut, ids, mc["q0"], 1.0, DT, 12, hp, device,
                     stats=st1)
        wall1 = time.perf_counter() - t0
        prof = profile_window(lambda: run_mainstem(
            hyb, cut, ids, mc["q0"], 1.0, DT, 12, hp, device),
            host_ops=False)
        idle = (None if prof["busy_ms"] is None
                else 1.0 - prof["busy_ms"] / (wall1 * 1e3))
        out.update(idle=idle,
                   kernels_per_substep=prof["launches"] / st1["substeps"])
        log(f"phase 11: one profiled 1-step run_mainstem: "
            f"{prof['launches']} device kernels ("
            f"{out['kernels_per_substep']:.0f} per sub-step), busy "
            f"{prof['busy_ms']:.1f} ms against {wall1 * 1e3:.0f} ms "
            f"unprofiled (idle share {idle:.3f}); top {prof['top']}  "
            f"[{smi}]")
        # batch against solo runs of its trees over 1 step, in float64
        # with exact tables: trees of different widths pad columns, and
        # in float32 the batch then differs from its solo runs in the last
        # bits
        t0 = time.perf_counter()
        rel64 = _batch_vs_solo(device, hyb, fvd, ids, mc["q0"], "float64",
                               None, 1)
        if rel64 > 1e-12:
            raise AssertionError(f"phase 11: float64 batch differs from its "
                                 f"solo runs by {rel64:.3g}")
        log(f"phase 11: the batch of {n_trees} trees against their solo "
            f"runs over 1 step, float64 exact: max rel {rel64:.3g} (rtol "
            f"1e-12; {time.perf_counter() - t0:.1f} s)")
        # card against CPU on a 2-tree, nts_cmp-step cut
        two = {tw: case["h"]["domain"][tw]
               for tw in case["h"]["tailwaters"][:2]}
        cut_hyb = HybridDomain.from_routelink(case["h"]["rl"], two)
        cut_hyb.load_topobathy(Path(tmp) / "topobathy.parquet")
        tw_reach = cut_hyb.tailwater_reaches()
        db = np.full((cut_hyb.n_reaches, 30), np.nan)
        for tw in two:
            if tw in case["h"]["coastal"]:
                db[tw_reach[tw]] = case["h"]["coastal"][tw]
        cut_hyb.coastal_db, cut_hyb.coastal_dt_db = db, 3600.0
        for dtype_s, nel in (("float64", 0), ("float32", 128)):
            hp_c = HybridParameters(diffusive_dtype=dtype_s,
                                    diffusive_table_nel=nel)
            res = {}
            for dev_ in (device, "cpu"):
                t0 = time.perf_counter()
                r = run_mainstem(cut_hyb, fvd[:nts_cmp], ids, mc["q0"], 1.0,
                                 DT, 12, hp_c, dev_)
                res[dev_] = (_mainstem_values(r), time.perf_counter() - t0)
            bar = _diffusive_bars(res[device][0], res["cpu"][0], dtype_s,
                                  f"phase 11 {dtype_s} card vs cpu")
            log(f"phase 11: 2 trees, {nts_cmp} steps, {dtype_s} nel {nel}, "
                f"card vs cpu: {bar} (card {res[device][1]:.2f} s, cpu "
                f"{res['cpu'][1]:.2f} s)")
    log(f"phase 11: hybrid part {time.perf_counter() - t_phase:.1f} s")
    return out


def _bmi_network(n: int, n_basins: int, n_lakes: int, seed: int):
    """Phase 9's regional network as BMI pushes: segment and waterbody
    arrays, ``n_lakes`` level-pool lakes each between a segment and its
    downstream segment, and a lateral inflow per segment."""
    from troute_torch import synthetic
    ids, down = regional_network(n, n_basins, seed)
    rng = np.random.default_rng(seed)
    chan = synthetic.channel_params(n, rng)
    seg = rng.choice(np.flatnonzero(down > 0), n_lakes, replace=False)
    lakes = 20_000_000 + np.arange(n_lakes, dtype=np.int64)
    toid = down.copy()
    toid[seg] = lakes
    v = dict(segment_id=ids, segment_toid=toid, waterbody_id=lakes,
             waterbody_toid=down[seg], LkArea=rng.uniform(1.0, 3.0, n_lakes),
             h0=rng.uniform(10.0, 11.5, n_lakes), qd0=np.zeros(n_lakes))
    for name, val in zip(("LkMxE", "OrificeA", "OrificeC", "OrificeE",
                          "WeirC", "WeirE", "WeirL", "ifd"),
                         (12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 0.9)):
        v[name] = np.full(n_lakes, val)
    v.update(chan)
    qlat = rng.uniform(0.1, 2.0, n)
    return v, qlat


def _bmi(device, pushes: dict, qlat, config: str = ""):
    from troute_torch.bmi import BmiTroute
    bmi = BmiTroute(device=device)
    bmi.initialize(config)
    for k, val in pushes.items():
        bmi.set_value(k, val)
    bmi.set_value("land_surface_water_source__volume_flow_rate", qlat)
    return bmi


_BMI_OUT = ("channel_exit_water_x-section__volume_flow_rate",
            "channel_water_flow__speed", "channel_water__mean_depth",
            "lake_water~outgoing__volume_flow_rate", "lake_surface__elevation")


def _bmi_values(bmi) -> np.ndarray:
    return np.concatenate([bmi.get_value(k) for k in _BMI_OUT])


def _engine_values(bmi, fvd_step) -> np.ndarray:
    """``_bmi_values`` of an engine run's step on ``bmi``'s network (a
    reservoir row's depth column holds its water elevation)."""
    ids = np.asarray(bmi.get_value("segment_id"), np.int64)
    rows, _ = bmi._rows_of(ids)
    res = bmi._topo.reservoir_rows
    return np.concatenate([fvd_step[rows, 0], fvd_step[rows, 1],
                           fvd_step[rows, 2], fvd_step[res, 0],
                           fvd_step[res, 2]])


def _warm_copy(src, dst, device):
    """``src``'s routing state, time 0, into ``dst`` on ``device``."""
    dst._build_network()
    dst._q, dst._d, dst._elev = (t.to(device).clone()
                                 for t in (src._q, src._d, src._elev))


def phase_bmi(device, dev: dict, n: int, n_basins: int, n_lakes: int,
              updates: int, steps: int) -> dict:
    """Phase 11 (b): the routing BMI on the card (the module docstring)."""
    import tempfile
    import torch
    import yaml
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.routing import engine
    smi = dev["smi"]
    t_phase = time.perf_counter()
    pushes, qlat = _bmi_network(n, n_basins, n_lakes, seed=9)
    out = dict(launches=0)
    bmi = _bmi(device, pushes, qlat)
    times, host = [], []
    for k in range(1, updates + 1):
        mcc.LAUNCHES = 0
        l1_reset()
        t0 = time.perf_counter()
        bmi.set_value("land_surface_water_source__volume_flow_rate", qlat)
        t1 = time.perf_counter()
        bmi.update_until(k * steps * DT)
        t2 = time.perf_counter()
        for name in _BMI_OUT[:3]:
            bmi.get_value(name)
        t3 = time.perf_counter()
        if mcc.LAUNCHES != steps:
            raise AssertionError(f"phase 11: a short update launched "
                                 f"{mcc.LAUNCHES} B1 kernels for {steps} "
                                 "steps")
        l1_read(steps, f"phase 11: BMI update {k}", 11)
        out["launches"] += mcc.LAUNCHES
        times.append(t3 - t0)
        host.append((t1 - t0) + (t3 - t2))
    got = _bmi_values(bmi)
    # the same inputs through one route_stepped call
    ref = _bmi(device, pushes, qlat)
    ref._build_network()
    ql = np.zeros((1, ref._topo.n_nodes), np.float32)
    rows, _ = ref._rows_of(pushes["segment_id"])
    ql[0, rows] = qlat
    cfg = engine.RoutingConfig(dt=DT, nts=updates * steps,
                               qts_subdivisions=1, assume_short_ts=True)
    mcc.LAUNCHES = 0
    l1_reset()
    r = engine.route_stepped(ref._net, ref._chan, ref._lp, cfg, ref._q,
                             ref._d, ref._elev,
                             torch.as_tensor(ql, device=device))
    l1_read(updates * steps, "phase 11: the BMI's route_stepped reference",
            11)
    out["launches"] += mcc.LAUNCHES
    want = _engine_values(ref, r["flowveldepth"][-1].cpu().numpy())
    if not np.array_equal(got.astype(np.float32), want):
        raise AssertionError(f"phase 11: {updates} BMI updates differ from "
                             f"one {updates * steps}-step route_stepped call")
    if not np.isfinite(got).all():
        raise AssertionError("phase 11: non-finite BMI output")
    med = statistics.median(times[1:])
    share = statistics.median(h / t for h, t in zip(host[1:], times[1:]))
    t_end = updates * steps * DT
    mcc.LAUNCHES = 0
    prof = profile_window(lambda: bmi.update_until(t_end + steps * DT))
    out["launches"] += mcc.LAUNCHES
    idle = (None if prof["busy_ms"] is None
            else 1.0 - prof["busy_ms"] / (med * 1e3))
    out.update(ms_update=med * 1e3, host_share=share,
               kernels_update=prof["launches"], idle=idle)
    log(f"phase 11: BMI short mode, {n} segments, {n_lakes} lakes: "
        f"{updates} update_until calls of {steps} steps, bit for bit equal "
        f"to one {updates * steps}-step route_stepped call; "
        f"{med * 1e3:.2f} ms per update (median of {updates - 1} after "
        f"the first; first {times[0] * 1e3:.1f} ms), set_value/get_value "
        f"share {share:.3f}; one profiled update: {prof['launches']} device "
        f"kernels ({steps} of them B1), busy {prof['busy_ms']:.2f} ms "
        f"(idle share {idle:.3f}); top {prof['top']}  [{smi}]")
    # fixed-point updates from that warm state
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = str(Path(tmp) / "strict.yaml")
        with open(cfg_path, "w") as f:
            yaml.safe_dump({"compute_parameters": {
                "assume_short_ts": False,
                "forcing_parameters": {"dt": DT, "nts": 24}}}, f)
        fp = _bmi(device, pushes, qlat, cfg_path)
        _warm_copy(bmi, fp, device)
        warm = tuple(t.clone() for t in (fp._q, fp._d, fp._elev))
        vals, sweeps, fp_times = [], [], []
        for k in (1, 2):
            mcc.LAUNCHES = 0
            t0 = time.perf_counter()
            fp.update_until(k * steps * DT)
            fp_times.append(time.perf_counter() - t0)
            counts = fp.last_update_counts
            if mcc.LAUNCHES != counts["mc_calls"]:
                raise AssertionError(f"phase 11: fixed-point update launched "
                                     f"{mcc.LAUNCHES} B1 kernels, the "
                                     f"engine counted {counts['mc_calls']}")
            out["launches"] += mcc.LAUNCHES
            sweeps += counts["strict_sweeps"]
            vals.append(_bmi_values(fp))
        cfg = engine.RoutingConfig(dt=DT, nts=2 * steps, qts_subdivisions=1,
                                   strict_iterative=True)
        mcc.LAUNCHES = 0
        r = engine.route_stepped(fp._net, fp._chan, fp._lp, cfg, *warm,
                                 torch.as_tensor(ql, device=device))
        out["launches"] += mcc.LAUNCHES
        fvd = r["flowveldepth"].cpu().numpy()
        want = np.concatenate([_engine_values(fp, fvd[steps - 1]),
                               _engine_values(fp, fvd[-1])])
        bar = check_strict_f32(np.concatenate(vals), want,
                               "phase 11 BMI fixed point")
        out.update(sweeps_per_step=float(np.mean(sweeps)),
                   ms_update_fixed_point=float(np.mean(fp_times)) * 1e3)
        log(f"phase 11: BMI assume_short_ts False, 2 updates of {steps} "
            f"steps from the warm state: {np.mean(sweeps):.2f} sweeps per "
            f"step (max {max(sweeps)}), {out['ms_update_fixed_point']:.1f} "
            f"ms per update, B1 launches = the engine's mc_calls; against "
            f"route_stepped's strict fixed point: {bar}  [{smi}]")
        # card against CPU, 2 updates of one step in each mode (a
        # fixed-point sweep on the host solves every lane: ~50 sweeps per
        # step at ~0.1 s each)
        for name, path in (("short", ""), ("fixed point", cfg_path)):
            res = {}
            for dev_ in (device, "cpu"):
                b = _bmi(dev_, pushes, qlat, path)
                if path:
                    _warm_copy(bmi, b, dev_)
                mcc.LAUNCHES = 0
                v = []
                for k in (1, 2):
                    b.update_until(k * DT)
                    v.append(_bmi_values(b))
                if dev_ != "cpu":
                    out["launches"] += mcc.LAUNCHES
                elif mcc.LAUNCHES:
                    raise AssertionError("phase 11: the CPU BMI launched B1")
                res[dev_] = np.concatenate(v)
            if name == "short":
                st = check_f32_bar(res[device], res["cpu"],
                                   "phase 11 BMI short card vs cpu",
                                   max_share=1e-5)
                bar = (f"f32 bar: median {st['median']:.3g}, p95 "
                       f"{st['p95']:.3g}, max {st['max']:.3g}")
            else:
                bar = check_strict_f32(res[device], res["cpu"],
                                       "phase 11 BMI fixed point card vs cpu")
            log(f"phase 11: BMI {name}, 2 updates of one step, card vs "
                f"cpu: {bar}")
    log(f"phase 11: BMI part {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------------------------- phase 12

def _conus_world_1(device, dev: dict, n: int, nts: int) -> dict:
    """Phase 12 (a): ``route_sharded_global`` in a 1-rank NCCL group on
    phase 4's CONUS set-up against ``route_stepped``, bit for bit; the
    partition's host seconds at 1 and 4 ranks; seg-ts/s of the sharded
    short driver and of ``route_stepped`` in interleaved turns."""
    import tempfile
    import torch
    import torch.distributed as dist
    from troute_torch import synthetic
    from troute_torch.network.topology import build_topology
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.ops.levelpool import LevelpoolParams
    from troute_torch.parallel.group import init_group
    from troute_torch.parallel.partition import (balanced_assignment,
                                                 partition_network)
    from troute_torch.parallel.sharded_engine import (
        build_sharded_inputs, route_sharded_global)
    from troute_torch.parallel.stepped_engine import route_sharded_stepped
    from troute_torch.routing import engine
    smi = dev["smi"]
    f32 = torch.float32
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    ids, down = synthetic.synthetic_conus(n)
    topo = build_topology(ids, down)
    chan = synthetic.channel_params(n, rng)
    q0 = rng.uniform(0.5, 5.0, n).astype(np.float32)
    d0 = rng.uniform(0.05, 0.8, n).astype(np.float32)
    qlat = rng.uniform(0.1, 2.0, (2, n)).astype(np.float32)
    cfg = engine.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=nts // 2,
                               assume_short_ts=True)
    setup_s = time.perf_counter() - t0
    parts = {}
    for w in (1, 4):
        t0 = time.perf_counter()
        a = balanced_assignment(topo, w)
        t1 = time.perf_counter()
        part = partition_network(topo, w, a)
        parts[w] = dict(part=part, assign_s=t1 - t0,
                        partition_s=time.perf_counter() - t1)
    p4 = parts[4]["part"]
    log(f"phase 12: CONUS N={n} (setup {setup_s:.1f} s); host partition "
        f"at 1 rank: balanced_assignment {parts[1]['assign_s']:.2f} s, "
        f"partition_network {parts[1]['partition_s']:.2f} s; at 4 ranks: "
        f"{parts[4]['assign_s']:.2f} s and {parts[4]['partition_s']:.2f} s "
        f"({p4.cut_edges} cut edges, {p4.perm_pairs.shape[0]} exchange "
        f"rounds, {p4.n_local} nodes per rank)")
    part = parts[1]["part"]

    def t(a):
        return torch.as_tensor(a, device=device)

    args = (engine.network_arrays_from_topology(topo, device=device),
            engine.ChannelParams.from_arrays(device=device, dtype=f32,
                                             **chan),
            LevelpoolParams(*[torch.ones(1, dtype=f32, device=device)] * 9),
            cfg, t(q0), t(d0), torch.zeros(1, dtype=f32, device=device),
            t(qlat))
    out = dict(launches=0)
    with tempfile.TemporaryDirectory() as tmp:
        init_group(device, "nccl", init_method=f"file://{tmp}/store",
                   rank=0, world_size=1)
        try:
            mcc.LAUNCHES = 0
            l1_reset()
            t0 = time.perf_counter()
            got = route_sharded_global(None, topo, chan, None, cfg, q0, d0,
                                       np.zeros(0, np.float32), qlat,
                                       part=part, dtype=f32, device=device)
            torch.cuda.synchronize()
            global_s = time.perf_counter() - t0
            if not mcc.LAUNCHES == got["mc_calls"] == nts:
                raise AssertionError(
                    f"phase 12: world size 1 launched {mcc.LAUNCHES} B1 "
                    f"kernels, the driver counted {got['mc_calls']}, for "
                    f"{nts} steps")
            # phase 4's CONUS network has no lakes
            l1_read(nts if topo.reservoir_rows.size else 0,
                    "phase 12 world size 1", 12)
            out["launches"] += mcc.LAUNCHES
            ref = engine.route_stepped(*args)
            for k, g, w in (("flowveldepth", got["flowveldepth"],
                             ref["flowveldepth"]),
                            ("q", got["state"].q, ref["state"].q),
                            ("depth", got["state"].depth,
                             ref["state"].depth)):
                if not torch.equal(g, w):
                    raise AssertionError(f"phase 12: world size 1 {k} "
                                         "differs from route_stepped")
            del got, ref
            inp = build_sharded_inputs(part, topo, chan, None, q0, d0, {},
                                       qlat, rank=0, device=device,
                                       dtype=f32)

            def stepped():
                engine.route_stepped(*args)

            def sharded():
                route_sharded_stepped(
                    None, inp, DT, nts, qts_subdivisions=cfg.qts_subdivisions,
                    band_shifts=part.band_shifts)

            times = {"route_stepped": [], "sharded": []}
            for fn in (stepped, sharded):
                fn()
            for _ in range(3):
                for name, fn in (("route_stepped", stepped),
                                 ("sharded", sharded), ("sharded", sharded),
                                 ("route_stepped", stepped)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    times[name].append(time.perf_counter() - t0)
        finally:
            dist.destroy_process_group()
    rate = {k: n * nts / min(v) for k, v in times.items()}
    med = {k: n * nts / statistics.median(v) for k, v in times.items()}
    out.update(partition_s=parts[1]["partition_s"],
               partition_s_4=parts[4]["partition_s"],
               assign_s_4=parts[4]["assign_s"], global_s=global_s,
               seg_ts_s=rate, seg_ts_s_median=med,
               ratio=rate["sharded"] / rate["route_stepped"])
    log(f"phase 12: CONUS world size 1 (NCCL, cuda:0), f32, {nts} steps: "
        f"route_sharded_global bit for bit equal to route_stepped (fvd and "
        f"state), B1 launches {nts} = steps = the driver's count; the "
        f"whole call {global_s:.3f} s (host plan and gather included); in "
        f"6 interleaved turns each, warm, best (median) seg-ts/s: sharded "
        f"driver {rate['sharded']:.4e} ({med['sharded']:.4e}), "
        f"route_stepped {rate['route_stepped']:.4e} "
        f"({med['route_stepped']:.4e}), ratio {out['ratio']:.3f}  [{smi}]")
    return out


def _global_values(res: dict) -> np.ndarray:
    """``_run_values`` of a rank's ``route_sharded_global`` result."""
    st = res["state"]
    return np.concatenate([np.asarray(a).ravel() for a in (
        res["fvd"], res["nudge"], st["q"], st["depth"], st["res_elev"],
        st["lastobs_val"], st["lastobs_time"])])


def _forced_cut(assign: np.ndarray) -> np.ndarray:
    """``assign`` with one more cut inside a basin: the first rank's last
    40 rows (post-order: the top of a tree) move to the second rank."""
    a = assign.copy()
    a[np.flatnonzero(a == 0)[-40:]] = 1
    return a


def _sharded_region(device, dev: dict, n: int, n_basins: int, nts: int,
                    nts_strict: int, n_trees: int) -> dict:
    """Phase 12 (b) and (c): 4 gloo ranks on ``device`` (one spawn); the
    regional network at world sizes 2 and 4 against ``route_stepped`` on
    the card, and ``run_mainstem``'s sharded branch on 2 ranks against
    the unsharded batch."""
    import tempfile
    import torch
    from troute_torch.config.schema import HybridParameters
    from troute_torch.parallel import ranks
    from troute_torch.parallel.group import spawn_ranks
    from troute_torch.parallel.partition import (balanced_assignment,
                                                 partition_network)
    from troute_torch.routing import engine
    from troute_torch.routing.hybrid import run_mainstem
    smi = dev["smi"]
    case = _network(n, n_res=300, n_gage=300, seed=9,
                    conn=regional_network(n, n_basins, seed=9))
    topo, chan, lp, q0, d0, elev0, qlat, gage = case
    res_params = np.stack(lp, axis=1)
    assign = {w: _forced_cut(balanced_assignment(topo, w)) for w in (2, 4)}
    out = dict(launches=0)
    start32 = {k: v.cpu().numpy() for k, v in _state_dict(
        _warm_state(device, torch.float32, case)).items()}
    short = engine.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=12,
                                 assume_short_ts=True)
    strict = engine.RoutingConfig(dt=DT, nts=nts_strict, qts_subdivisions=12,
                                  assume_short_ts=False,
                                  strict_iterative=True,
                                  strict_block_skip=False)

    def gcase(w, dtype, cfg, start=None, exchange="neighbor"):
        s = start or dict(q=q0, depth=d0, res_elev=elev0,
                          lastobs_val=gage["lastobs_val"],
                          lastobs_time=gage["lastobs_time"])
        return dict(kind="global", world=w, dtype=dtype, topo=topo,
                    chan=chan, res_params=res_params, cfg=cfg, q0=s["q"],
                    depth0=s["depth"], elev0=s["res_elev"], qlat=qlat,
                    da=dict(rows=gage["rows"], obs=gage["obs"],
                            lastobs_val=s["lastobs_val"],
                            lastobs_time=s["lastobs_time"],
                            decay_coeff=120.0),
                    assignment=assign[w], exchange=exchange)

    names, cases = [], []
    for w in (2, 4):
        for name, c in ((f"w{w} f64", gcase(w, "float64", short)),
                        (f"w{w} f64 allgather",
                         gcase(w, "float64", short, exchange="allgather")),
                        (f"w{w} f32", gcase(w, "float32", short)),
                        (f"w{w} strict f32",
                         gcase(w, "float32", strict, start32))):
            names.append(name)
            cases.append(c)
    with tempfile.TemporaryDirectory() as tmp:
        hcase = _hybrid_case(device, n, n_basins, n_trees, Path(tmp))
        hyb, htopo = hcase["hyb"], hcase["topo"]
        fvd1, _ = _hybrid_mc(device, hcase, 1)
        hp64 = HybridParameters(diffusive_dtype="float64",
                                diffusive_table_nel=0)
        margs = (hyb, fvd1, np.asarray(htopo.ids), hcase["mc"]["q0"], 1.0,
                 DT, 12, hp64, device)
        t0 = time.perf_counter()
        alone = run_mainstem(*margs)
        alone_s = time.perf_counter() - t0
        names.append("mainstem")
        cases.append(dict(kind="mainstem", world=2, args=margs))
        timed = [names.index("w2 f32"), names.index("w4 f32")]
        t0 = time.perf_counter()
        procs = spawn_ranks(ranks.run_and_time, 4, backend="gloo",
                            device=device, timeout=900,
                            args=(cases, timed, device))
        spawn_s = time.perf_counter() - t0
    res = {k: [p["cases"][i] for p in procs] for i, k in enumerate(names)}
    for r, p in enumerate(procs):
        if p["foreign"]:
            raise AssertionError(f"phase 12: rank {r} imported "
                                 f"{p['foreign']}")
        want = sum(c["mc_calls"] for c in p["cases"]
                   if c is not None and "mc_calls" in c)
        if p["launches_cases"] != want:
            raise AssertionError(f"phase 12: rank {r} launched "
                                 f"{p['launches_cases']} B1 kernels, its "
                                 f"drivers counted {want}")
        # the sharded drivers' own launches (not the timing runs)
        out["launches"] += p["launches_cases"]
    refs = {}
    for key, dtype, cfg_kw in (("f64", torch.float64, {}),
                               ("f32", torch.float32, {}),
                               ("strict f32", torch.float32,
                                dict(strict=True, start=start32,
                                     strict_block_skip=False))):
        steps = nts_strict if "strict" in key else nts
        refs[key] = _run_values(_route(device, dtype, case, steps, **cfg_kw))
    lines = {}
    for w in (2, 4):
        parts = res[f"w{w} f64"]
        for r in range(1, w):
            for k in names:
                if k.startswith(f"w{w}") and not np.array_equal(
                        res[k][r]["fvd"], res[k][0]["fvd"]):
                    raise AssertionError(f"phase 12: {k}: rank {r}'s "
                                         "result differs from rank 0's")
        for r in range(w):
            a, b = res[f"w{w} f64"][r], res[f"w{w} f64 allgather"][r]
            if not np.array_equal(_global_values(a), _global_values(b)):
                raise AssertionError(f"phase 12: world size {w}: neighbor "
                                     "and allgather exchanges differ")
        st64 = check_f64_network(_global_values(parts[0]), refs["f64"],
                                 f"phase 12 world size {w} f64")
        st32 = check_f32_bar(_global_values(res[f"w{w} f32"][0]),
                             refs["f32"], f"phase 12 world size {w} f32",
                             max_share=1e-5)
        strict_txt = check_strict_f32(
            _global_values(res[f"w{w} strict f32"][0]), refs["strict f32"],
            f"phase 12 world size {w} strict f32")
        tm = [procs[r]["times"][timed[(2, 4).index(w)]] for r in range(w)]
        ms_step = max(min(x["ms_step"]) for x in tm)
        exch = [x["exchange_ms"] for x in tm]
        bnd = [x["boundary_ms"] for x in tm if x["boundary_ms"] is not None]
        mc_calls = [res[f"w{w} f32"][r]["mc_calls"] for r in range(w)]
        lines[w] = dict(cut_edges=parts[0]["cut_edges"],
                        rounds=parts[0]["rounds"], ms_step=ms_step,
                        exchange_ms=max(exch), boundary_ms=max(bnd or [0.0]),
                        n_boundary=[x["n_boundary"] for x in tm],
                        mc_calls=mc_calls,
                        strict_sweeps=res[f"w{w} strict f32"][0][
                            "strict_sweeps"])
        log(f"phase 12: regional N={n}, world size {w} (gloo, every rank "
            f"on {device}), balanced_assignment + one forced mid-basin cut: "
            f"{parts[0]['cut_edges']} cut edges, {parts[0]['rounds']} "
            f"exchange rounds, boundary rows per rank "
            f"{lines[w]['n_boundary']}; every rank returned the same "
            f"result; neighbor = allgather bit for bit; against "
            f"route_stepped on the card: f64 {nts} steps off rtol 1e-9 at "
            f"{st64['off']} of {st64['n']} values (max rel {st64['max']:.3g})"
            f", f32 {nts} steps median {st32['median']:.3g} p95 "
            f"{st32['p95']:.3g} max {st32['max']:.3g}, strict f32 "
            f"{nts_strict} steps from a warm state: {strict_txt}; sweeps "
            f"{lines[w]['strict_sweeps']}; B1 launches per rank = the "
            f"driver's count (f32 short: {mc_calls})")
        log(f"phase 12: world size {w}, shared-card, host-staged, not "
            f"scaling: short driver f32 {ms_step:.2f} ms per step (slowest "
            f"rank, best of 3), one exchange {max(exch):.3f} ms, B1 on the "
            f"boundary rows {lines[w]['boundary_ms']:.3f} ms  [{smi}]")
    worst = 0.0
    want_q, want_d = _mainstem_values(alone)
    for r in range(2):
        got_q, got_d = _mainstem_values(res["mainstem"][r])
        for g, w_ in ((got_q, want_q), (got_d, want_d)):
            if g.shape != w_.shape:
                raise AssertionError("phase 12: sharded mainstem shape")
            worst = max(worst, float(rel_diff(g, w_).max()))
    if worst > 1e-12:
        raise AssertionError(f"phase 12: the sharded mainstem differs from "
                             f"the unsharded batch by {worst:.3g}")
    case_s = {k: round(v[0]["seconds"], 2) for k, v in res.items()}
    log(f"phase 12: run_mainstem sharded over 2 gloo ranks, {n_trees} "
        f"trees, float64 exact tables, 1 step: equal to the unsharded "
        f"batch to max rel {worst:.3g} (rtol 1e-12; unsharded "
        f"{alone_s:.1f} s); the 4-rank spawn took {spawn_s:.1f} s, rank "
        f"0's host seconds per case {case_s}")
    out.update(world=lines, mainstem_rel=worst, spawn_s=spawn_s)
    return out


def _sharded_cli(device, dev: dict, n: int, nts: int) -> dict:
    """Phase 12 (d): the command line with ``parallel_compute_method:
    sharded`` in 2 gloo ranks on ``device`` against the single-process
    command on the card."""
    import copy
    import tempfile
    import yaml
    from troute_torch.parallel import ranks
    from troute_torch.parallel.group import spawn_ranks
    flags = ["--cpu"] if device == "cpu" else []
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp) / "cli"
        case = _cli_domain(base, n, ("csv",))
        cfg = copy.deepcopy(case["cfg"])
        cfg["compute_parameters"]["forcing_parameters"].update(
            nts=nts, max_loop_size=1)
        single = _cli_run(base, cfg, "single.yaml", *flags)
        sh = copy.deepcopy(cfg)
        sh["compute_parameters"]["parallel_compute_method"] = "sharded"
        sh["output_parameters"]["csv_output"]["csv_output_folder"] = \
            "out_sharded"
        sh["output_parameters"]["lite_restart"][
            "lite_restart_output_directory"] = "restart_sharded"
        with open(base / "sharded.yaml", "w") as f:
            yaml.safe_dump(sh, f)
        t0 = time.perf_counter()
        procs = spawn_ranks(ranks.cli_main, 2, backend="gloo", device=device,
                            timeout=600,
                            args=(["-f", str(base / "sharded.yaml"),
                                   *flags],))
        spawn_s = time.perf_counter() - t0
        got = procs[0]
        for r, p in enumerate(procs):
            if p["foreign"]:
                raise AssertionError(f"phase 12 (d): rank {r} imported "
                                     f"{p['foreign']}")
            if not np.array_equal(p["fvd"], got["fvd"]):
                raise AssertionError(f"phase 12 (d): rank {r}'s flows "
                                     "differ from rank 0's")
            if p["mc_calls"] is None or p["launches"] != p["mc_calls"]:
                raise AssertionError(f"phase 12 (d): rank {r} launched "
                                     f"{p['launches']} B1 kernels, its "
                                     f"command counted {p['mc_calls']}")
        if procs[1]["written"]:
            raise AssertionError(f"phase 12 (d): rank 1 wrote "
                                 f"{procs[1]['written']}")
        names = [Path(w).name for w in got["written"]]
        if names != [w.name for w in single["written"]] or not all(
                Path(w).is_file() for w in got["written"]):
            raise AssertionError(f"phase 12 (d): rank 0 wrote {names}, the "
                                 f"single command {single['written']}")
        if got["fvd"].shape != (nts, case["ids"].size, 3) \
                or not np.isfinite(got["fvd"]).all():
            raise AssertionError("phase 12 (d): fvd shape or not finite")
        st = check_f32_bar(got["fvd"], single["fvd"],
                           "phase 12 (d) sharded command vs one process")
    log(f"phase 12: python -m troute_torch with parallel_compute_method: "
        f"sharded, N={n}, {nts} steps, in 2 gloo ranks on {device}: every "
        f"rank returned the same flows, rank 0 wrote {names}, rank 1 "
        f"nothing; against the single-process command on the card: f32 "
        f"bar median {st['median']:.3g} p95 {st['p95']:.3g} max "
        f"{st['max']:.3g}; B1 launches per rank "
        f"{[p['launches'] for p in procs]} = the command's count; ranks' "
        f"task_times "
        f"{got['task_times']}; spawn and run {spawn_s:.1f} s")
    return dict(launches=sum(p["launches"] for p in procs))


def phase_sharded(device, dev: dict, n_conus: int, n: int, n_basins: int,
                  nts: int, nts_strict: int, n_cli: int) -> dict:
    """Phase 12: multi-GPU routing on one card (the module docstring)."""
    t_phase = time.perf_counter()
    a = _conus_world_1(device, dev, n_conus, nts)
    b = _sharded_region(device, dev, n, n_basins, nts, nts_strict, 8)
    d = _sharded_cli(device, dev, n_cli, 6)
    log(f"phase 12: sharded part {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=a["launches"] + b["launches"] + d["launches"],
                conus_world_1={k: v for k, v in a.items()
                               if k != "launches"},
                region={w: v for w, v in b["world"].items()},
                mainstem_rel=b["mainstem_rel"], spawn_s=b["spawn_s"])


def foreign_modules() -> list[str]:
    """Modules of JAX, of the JAX package or of its ``bench.py`` that this
    process has imported."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "troute_tpu", "bench")
                  or m.startswith(("jax.", "jaxlib", "troute_tpu.")))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="earlier checkout whose B1 and B2 are timed in "
                         "turns with this one's")
    ap.add_argument("--diffusive-steps", type=int, default=0,
                    help="routing steps of every phase-10 timed run (the "
                         "default times 24 for the uniform-table leg and 6 "
                         "for the others, to keep the script within its "
                         "time limit)")
    ap.add_argument("--engine-segments", type=int, default=100_000,
                    help="segments of phase 3's network (the default is "
                         "the checked size; another lists the f32 values "
                         "past 5e-2 of that size)")
    ap.add_argument("--phases", default="2-14",
                    help="phases to run after phase 1, as a range or a "
                         "comma list (e.g. 9,10); the default runs all, "
                         "and only a full run prints the result lines")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not (ROOT / "troute_torch" / "csrc" / "mc_secant.cu").is_file():
        print("chip_smoke: run from the root of a troute checkout",
              file=sys.stderr)
        return 1
    phases = set()
    for part in opts.phases.split(","):
        lo, _, hi = part.partition("-")
        phases.update(range(int(lo), int(hi or lo) + 1))
    full = phases >= set(range(2, 15)) and opts.engine_segments == 100_000
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    device = "cuda:0"
    torch.cuda.set_device(device)
    t_start = time.perf_counter()
    dev = phase_device(device)
    baseline = None if opts.baseline is None else Baseline(
        opts.baseline / "troute_torch" / "csrc" / "mc_secant.cu")
    if 2 in phases:
        r = phase_kernel_vs_plain(device, dev, n32=N_CONUS, n64=1_000_000,
                                  baseline=baseline)
    if 13 in phases:
        lp = phase_levelpool(device, dev, n_res=N_CONUS_LAKES, n_nodes=N_CONUS)
    if 14 in phases:
        lpd = phase_levelpool_da(device, dev, n_res=N_CONUS_LAKES,
                                 n_nodes=N_CONUS)
    if 3 in phases:
        phase_engine_card_vs_cpu(device, n=opts.engine_segments, nts=24)
    if phases & {4, 7}:
        m = phase_main_path(device, dev, n=N_CONUS, nts=24,
                            baseline=baseline)
    if 5 in phases:
        phase_skip_vs_plain(device, n32=N_CONUS, n64=1_000_000)
    if 6 in phases:
        phase_strict_card_vs_cpu(device, n=25_000, nts=3)
    if 7 in phases:
        s = phase_strict_main_path(device, dev, m["setup"],
                                   baseline=baseline)
    if phases & {4, 7}:
        del m["setup"]
        torch.cuda.empty_cache()
    if 8 in phases:
        c = phase_cli(dev, n_full=N_CONUS, n_small=25_000, n_strict=25_000)
    if opts.baseline is not None:
        main_path_turns(opts.baseline, n=N_CONUS, nts=24, smi=dev["smi"])
    if 9 in phases:
        lv = phase_level_scan(device, dev, n=N_REGION, n_basins=N_BASINS,
                              nts=24, nts_cpu=2, n_cli=25_000,
                              cli_basins=100)
        torch.cuda.empty_cache()
    if 10 in phases:
        d = phase_diffusive(device, dev, r=2048, c=16, nts=24, r_cpu=256,
                            nts_cmp=4, batch=8,
                            timed_steps=opts.diffusive_steps)
    if 11 in phases:
        hy = phase_hybrid(device, dev, n=N_REGION, n_basins=N_BASINS,
                          n_trees=8, nts=24, nts_cmp=2)
        bm = phase_bmi(device, dev, n=N_REGION, n_basins=N_BASINS,
                       n_lakes=300, updates=12, steps=12)
    if 12 in phases:
        sh = phase_sharded(device, dev, n_conus=N_CONUS, n=N_REGION,
                           n_basins=N_BASINS, nts=24, nts_strict=6,
                           n_cli=25_000)
    if foreign_modules():
        raise AssertionError(f"the port's run imported {foreign_modules()}")
    log(f"total {time.perf_counter() - t_start:.1f} s; imported nothing of "
        f"JAX, troute_tpu or bench.py")
    if not full:
        log(f"phases {sorted(phases)} only: no result lines")
        return 0
    src = "troute_torch/csrc/mc_secant.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "trips_mean",
            "trips_max", "evals_mean")
    print(json.dumps({"kernels": [
        {"name": "mc_secant", "route": "cuda", "source": src,
         "replaces": "troute_tpu/ops/muskingum_pallas.py:42",
         "launches": m["launches"] + s["launches"]["mc_secant"]
         + c["launches"]["mc_secant"] + lv["launches"]
         + hy["launches"] + bm["launches"] + sh["launches"],
         "launches_by_path": {"phase 4": m["launches"],
                              "phase 7": s["launches"]["mc_secant"],
                              "phase 8": c["launches"]["mc_secant"],
                              "phase 9": lv["launches"],
                              "phase 11": hy["launches"] + bm["launches"],
                              "phase 12": sh["launches"]},
         "max_abs_err": max(m["max_abs"], r["max_abs"]),
         **{k: m[k] for k in keys}, "library_ms": None,
         "floor_ms": m["floor_ms"], "baseline_ms": m["baseline_ms"],
         "conus_ranges": {k: r[k] for k in keys + ("floor_ms",
                                                   "baseline_ms")},
         "level_scan": {k: lv[k] for k in ("rows", "ms_step",
                                           "launches_step",
                                           "b1_ms_per_launch", "idle")}},
        {"name": "mc_secant_skip", "route": "cuda", "source": src,
         "replaces": "troute_tpu/ops/muskingum_pallas.py:51",
         "launches": m["skip_launches"] + s["launches"]["mc_secant_skip"]
         + c["launches"]["mc_secant_skip"],
         "launches_by_path": {"phase 4": m["skip_launches"],
                              "phase 7": s["launches"]["mc_secant_skip"],
                              "phase 8": c["launches"]["mc_secant_skip"],
                              "phase 9": 0, "phase 11": 0, "phase 12": 0},
         "max_abs_err": s["max_abs"], **{k: s[k] for k in keys},
         "library_ms": None, "floor_ms": s["floor_ms"],
         "baseline_ms": s["baseline_ms"],
         "b1_ms_same_inputs": s["b1_ms"],
         "active_blocks": s["active_blocks"]},
        {"name": "levelpool", "route": "cuda",
         "source": "troute_torch/csrc/levelpool.cu",
         "replaces": "troute_torch/ops/levelpool.py:levelpool_step (no "
                     "pallas_call: the JAX package's level pool is XLA's)",
         "launches": sum(L1_BY_PATH.values()),
         "launches_by_path": {f"phase {k}": v
                              for k, v in sorted(L1_BY_PATH.items())},
         "max_abs_err": lp["max_abs"],
         **{k: lp[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "enqueue_ms", "plain_enqueue_ms",
                               "plain_kernels", "bytes_per_lake")},
         "library_ms": None},
        {"name": "levelpool_da", "route": "cuda",
         "source": "troute_torch/csrc/levelpool.cu",
         "replaces": "troute_torch/ops/levelpool.py:levelpool_step, "
                     "troute_torch/ops/reservoir_da.py:"
                     "typed_reservoir_dispatch and two index_put (no "
                     "pallas_call: the JAX package's are XLA's)",
         "launches": lpd["launches"],
         "launches_by_path": {"phase 14": lpd["launches"]},
         "max_abs_err": lpd["max_abs"],
         **{k: lpd[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "enqueue_ms", "plain_enqueue_ms",
                                "plain_kernels", "bytes_per_lake",
                                "walks")},
         "library_ms": None}],
        "cli": {k: c[k] for k in ("task_times", "route_seg_ts_s",
                                  "command_seg_ts_s", "stages")},
        "diffusive": d,
        "hybrid": {k: v for k, v in hy.items() if k != "launches"},
        "bmi": {k: v for k, v in bm.items() if k != "launches"},
        "sharded": {k: v for k, v in sh.items() if k != "launches"}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Clocks, statistics, the device trace and the import check of the
benchmark.

The trace arithmetic (``busy_union``, the kernel, memcpy and memset
intervals of a ``torch.profiler`` chrome trace) is copied from
``chip_smoke.py:profile_window``; ``smi_query`` from
``chip_smoke.py:smi_query``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

# modules that no run may load, compared by whole top-level name: JAX,
# the JAX package and its benchmark script
FORBIDDEN = ("jax", "jaxlib", "flax", "troute_tpu", "bench")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def foreign_modules(names=FORBIDDEN, modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``names``."""
    mods = sys.modules if modules is None else modules
    return sorted(m for m in mods if m.split(".", 1)[0] in names)


def p95(values) -> float:
    """Nearest-rank 95th percentile: the smallest sample with at least 95%
    of all samples at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    return xs[max(math.ceil(0.95 * len(xs)) - 1, 0)]


def rate(work: float, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0.0:
        raise ValueError("empty window")
    return work / seconds


class HostClock:
    """Unit latency by the host's clock (CPU runs and tests only)."""

    def start(self):
        return time.perf_counter()

    def stop(self, token) -> float:
        return (time.perf_counter() - token) * 1e3


class CudaClock:
    """Unit latency on the device's clock: CUDA events recorded before and
    after the unit, then a synchronize, so the time runs from when the
    idle stream reached the first event to when it finished the unit's
    last work, with the host's launches in between."""

    def __init__(self, torch):
        self.torch = torch

    def start(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def stop(self, token) -> float:
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.torch.cuda.synchronize()
        return float(token.elapsed_time(e))


def smi_query(fields: str) -> str:
    """``nvidia-smi --query-gpu=<fields>`` of the first card, or "" where
    nvidia-smi is missing or fails."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return ""
    lines = proc.stdout.strip().splitlines()
    return lines[0] if lines else ""


def busy_union(spans) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def merged(spans) -> list:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def gaps_in(spans, lo: float, hi: float) -> list:
    """The idle gaps within [lo, hi] between the intervals ``spans``."""
    out, at = [], lo
    for a, b in merged(spans):
        a, b = max(a, lo), min(b, hi)
        if a >= b:
            continue
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


class Trace:
    """The events of one profiled stretch (times in microseconds on the
    profiler's timeline): device events, host events, and the stretch's
    bounds: the benchmark's own annotation named ``stretch`` where the
    trace holds host events, else the first device event's start and the
    last one's end."""

    def __init__(self, events: list, stretch: str | None = None):
        self.device = [(e.get("name", "?"), float(e["ts"]),
                        float(e["ts"]) + float(e["dur"]))
                       for e in events
                       if e.get("cat") in DEVICE_CATS and "dur" in e]
        self.host = [(e.get("name", "?"), float(e["ts"]),
                      float(e["ts"]) + float(e["dur"]))
                     for e in events
                     if e.get("cat") in HOST_CATS and "dur" in e]
        self.stretch = stretch
        marks = [(a, b) for name, a, b in self.host if name == stretch]
        if marks:
            self.lo, self.hi = marks[0]
        elif self.device:
            self.lo = min(a for _, a, _ in self.device)
            self.hi = max(b for _, _, b in self.device)
        else:
            self.lo = self.hi = 0.0

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    @property
    def busy_s(self) -> float:
        return busy_union([(max(a, self.lo), min(b, self.hi))
                           for _, a, b in self.device
                           if min(b, self.hi) > max(a, self.lo)]) / 1e6

    def kernels(self, pattern: str | None = None) -> list:
        """(name, start, end) of device events in the stretch whose name
        holds ``pattern`` (all of them for None)."""
        return [(n, a, b) for n, a, b in self.device
                if a >= self.lo and b <= self.hi
                and (pattern is None or pattern in n)]

    def top_ops(self, k: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        by = {}
        for n, a, b in self.kernels():
            by[n] = by.get(n, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])
                ][:k]

    def idle_by_host(self, k: int = 10, longest: int = 2000) -> list:
        """[host activity, seconds]: the ``longest`` idle gaps of the device
        in the stretch, each named by the innermost host event under its
        midpoint (the stretch's own annotation when the host ran Python
        between operators; "host idle" outside it), summed by name, most
        first."""
        import numpy as np
        gaps = sorted(gaps_in([(a, b) for _, a, b in self.device],
                              self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:longest]
        names = [h[0] for h in self.host]
        starts = np.asarray([h[1] for h in self.host])
        ends = np.asarray([h[2] for h in self.host])
        by = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            under = np.flatnonzero((starts <= mid) & (ends >= mid))
            name = (names[under[np.argmin(ends[under] - starts[under])]]
                    if under.size else "host idle")
            if name == self.stretch:
                name = "python between operators"
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])
                ][:k]


def profile(torch, fn, host: bool, stretch: str = "stretch") -> Trace:
    """Run ``fn`` under ``torch.profiler`` and read the chrome trace back
    from a temporary file.  With ``host`` the trace also holds the host's
    operators, inside an annotation named ``stretch`` that bounds the
    stretch; recording them slows the host, so device busy and idle time
    are read from a trace without them (``host`` False), which the
    device's own first and last events bound."""
    from torch.profiler import ProfilerActivity, profile as _profile
    from torch.profiler import record_function
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with _profile(activities=acts) as prof:
        if host:
            with record_function(stretch):
                fn()
                torch.cuda.synchronize()
        else:
            fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return Trace(events, stretch if host else None)


def idle_share_pct(trace: Trace):
    """Share of the traced stretch in which the device ran no kernel,
    memcpy or memset, in percent; None without device activity."""
    if not trace.device or trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)

"""Run one cell of the benchmark once.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:

* a configuration's file (``configs/<name>.json``) names its driver
  (``drivers/<driver>.py``), the names of the end-to-end metrics its
  driver's units report (a tail of unit latencies and, where it is steady
  enough to bound, a rate of work over the window), its
  traced stretch and the limits of its correctness check;
* a traffic mix is ``traffic/<traffic>.json``, read by ``gen/forcing.py``;
* a per-layer metric is ``metrics/<name>.py``, whose ``read(view)``
  returns its value or None when it finds nothing to read.

A run: set-up (the driver builds the network and forcing from the seed and
routes the spin-up; ``setup_s`` runs from the start of the process), a
closed-loop window of units for ``seconds`` (with ``trace``, the first
units of the window are profiled: the configuration's ``trace_units``
with the device's activity alone, for the per-layer metrics, then
``HOST_UNITS`` with the host's operators too, for the breakdown of the
device's idle gaps), the import check, the device's memory
peak, then the judge, which runs the plain reference on the kept units.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

from hydrobench import measure, roofline

HERE = Path(__file__).resolve().parent
STRETCH = "hydrobench.stretch"
# units of the second traced stretch, which records the host's operators
# to name what the host did while the device sat idle
HOST_UNITS = 2


class RunError(Exception):
    """A run that must end without a result."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, workload: str, root: Path,
         traffic_dir: Path = HERE / "traffic") -> tuple:
    """(workload entry, configuration file's content, traffic file's
    content) of ``workload``; ``root`` is where the manifest's paths
    start."""
    wl = [w for w in manifest["workloads"] if w["name"] == workload]
    if not wl:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json")
    wl = wl[0]
    conf = [c for c in manifest["configs"] if c["name"] == wl["config"]][0]
    cfg = load_json(root / conf["file"])
    traffic = load_json(traffic_dir / f"{wl['traffic']}.json")
    return wl, cfg, traffic


def metrics_of(manifest: dict, kind: str, workload: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this workload
    reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or workload in m["workloads"]]


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        raise RunError(f"no reader {path.relative_to(HERE.parent)}")
    spec = importlib.util.spec_from_file_location(
        "hydrobench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class View:
    """What a per-layer reader reads: the profiled stretch's trace, how
    many units and steps it held, the driver (for counts the reference
    makes and the benchmark's own spans), the window's untraced part, and
    the card's published peaks (None for a card the table lacks)."""

    def __init__(self, trace, units: int, driver, device_name: str):
        self.trace = trace
        self.units = units
        self.steps = driver.traced_steps(units)
        self.driver = driver
        self.peak = roofline.PEAKS.get(device_name)
        self._b1 = None
        # units routed in the window after the traced stretches, and the
        # host-clock seconds from their end to the window's close
        self.free_units, self.free_s = 0, 0.0

    def b1_calls(self):
        if self._b1 is None:
            self._b1 = self.driver.b1_calls(self.units)
        return self._b1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def host_probe_ms() -> float:
    """Milliseconds of a fixed piece of pure Python work: the host's own
    speed, logged beside each window to tell a slow host from a slow
    program."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(1_000_000):
        acc += i & 7
    return (time.perf_counter() - t0) * 1e3


def run(manifest: dict, root: Path, workload: str, seed: int,
        seconds: float, trace: bool, device, t_start: float,
        clock=None, control: bool = False,
        traffic_dir: Path = HERE / "traffic") -> dict:
    """One run of ``workload``; returns the result line's object.  On a CPU
    ``device`` (tests) pass a ``measure.HostClock``.  ``control`` also
    judges the control (the reference in bfloat16 in the program's place)
    on the same kept units, under the key "control"; the benchmark's own
    runs never do."""
    import torch

    wl, cfg, traffic = cell(manifest, workload, root, traffic_dir)
    on_cuda = torch.device(device).type == "cuda"
    clock = clock or measure.CudaClock(torch)
    driver_mod = importlib.import_module(f"hydrobench.drivers.{cfg['driver']}")
    driver = driver_mod.Driver(cfg, traffic, seed, device)
    driver.setup()
    if on_cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")

    lat, ends, k = [], [], 0
    trace_units = int(cfg["trace_units"]) if trace else 0
    view = None

    def one():
        nonlocal k
        tok = clock.start()
        driver.unit(k)
        ms = clock.stop(tok)
        driver.after(k, ms)
        lat.append(ms)
        ends.append(time.perf_counter())
        k += 1

    probe = [host_probe_ms()]
    t0 = time.perf_counter()
    if trace_units:
        def stretch(units):
            return lambda: [one() for _ in range(units)]
        view = View(measure.profile(torch, stretch(trace_units), False),
                    trace_units, driver,
                    torch.cuda.get_device_name(0) if on_cuda else "cpu")
        host = measure.profile(torch, stretch(HOST_UNITS), True, STRETCH)
    # the window's untraced part: the units routed after the traced
    # stretches, and its host-clock start
    k_free, t_free = k, time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one()
    t1 = time.perf_counter()
    window_s = t1 - t0
    probe.append(host_probe_ms())

    foreign = measure.foreign_modules()
    if foreign:
        raise RunError("foreign modules loaded: " + ", ".join(foreign))
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    driver.free_program()
    if on_cuda:
        torch.cuda.empty_cache()

    names = cfg["metrics"]
    rate_name = names.get("rate", "rate")
    e2e = {names["tail"]: measure.p95(lat), "setup_s": setup_s}
    if "rate" in names:
        e2e[rate_name] = measure.rate(k * driver.unit_work(), window_s)
    if view is not None:
        view.free_units, view.free_s = k - k_free, t1 - t_free
    log(f"window {window_s:.3f} s, {k} units; {names['tail']} over {len(lat)}"
        f" samples, median {sorted(lat)[len(lat) // 2]!r} ms")
    quarters = [sorted(q)[len(q) // 2] for q in
                (lat[i * len(lat) // 4:(i + 1) * len(lat) // 4]
                 for i in range(4)) if q]
    log(f"unit median by quarter of the window {quarters!r} ms; host probe"
        f" {probe[0]!r} ms before, {probe[1]!r} ms after")
    for cut in range(10, int(seconds), 10):
        done = sum(e - t0 <= cut for e in ends)
        if done:
            log(f"first {cut} s of the window: {rate_name} "
                f"{measure.rate(done * driver.unit_work(), cut)!r}, "
                f"{names['tail']} {measure.p95(lat[:done])!r}")

    metrics = {}
    breakdown = None
    if trace:
        t_read = time.perf_counter()
        for m in metrics_of(manifest, "per_layer", workload):
            v = load_metric(m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": view.trace.top_ops(),
                     "idle_gaps": host.idle_by_host()}
        log(f"per-layer metrics read in {time.perf_counter() - t_read:.3f}"
            " s")
    else:
        for m in metrics_of(manifest, "end_to_end", workload):
            if m["name"] not in e2e:
                raise RunError(f"the {cfg['driver']} driver does not "
                               f"report {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    limits = cfg["judge"]["limits"]
    t_judge = time.perf_counter()
    per_unit = driver.judge()
    log(f"judge {time.perf_counter() - t_judge:.3f} s")
    checks, failed = {}, 0
    for name, nums in per_unit.items():
        bad = [c for c, v in nums.items()
               if math.isnan(v) or v > limits[c]]
        failed += bool(bad)
        log(f"kept unit {name}: " + ", ".join(f"{c} {v!r}"
                                             for c, v in nums.items()))
        for c, v in nums.items():
            old = checks.get(c)
            checks[c] = v if old is None or math.isnan(v) else max(old, v)
    correct = failed == 0 and bool(per_unit)
    result = {"correct": correct, "attempted": k, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_cuda else "cpu",
                         "kind": (torch.cuda.get_device_name(0) if on_cuda
                                  else "cpu"),
                         "count": int(wl["chips"]),
                         "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = view.trace.busy_s
        result["device"]["window_s"] = view.trace.window_s
        result["breakdown"] = breakdown
    if control:
        result["control"] = driver.judge(control=True)
    result["checks"] = {c: {"value": v, "limit": limits[c]}
                        for c, v in checks.items()}
    return result

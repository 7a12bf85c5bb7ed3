"""Entry functions of the ranks that ``group.spawn_ranks`` starts.

A spawned rank imports the module of its target, so these functions live
here, in a module that imports nothing of JAX: a target defined in a test
file would import JAX and the JAX package into every rank.  Each runs in
a rank of the default group that ``spawn_ranks`` made, takes and returns
plain NumPy data (the launcher pickles both ways), and reports the kernel
B1 launches of its process (``muskingum_cuda.LAUNCHES``, counted per
process) and the modules of JAX, the JAX package or ``bench.py`` it
imported.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist


def foreign_modules() -> list[str]:
    """Modules of JAX, of the JAX package or of its ``bench.py`` that this
    process has imported."""
    return sorted(m for m in sys.modules
                  if m in ("jax", "troute_tpu", "bench")
                  or m.startswith(("jax.", "jaxlib", "troute_tpu.")))


def _process() -> dict:
    from troute_torch.ops import muskingum_cuda as mcc
    return {"launches": mcc.LAUNCHES, "skip_launches": mcc.SKIP_LAUNCHES,
            "foreign": foreign_modules()}


def _np(x):
    from troute_torch.convert import to_numpy
    return to_numpy(x)


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[name]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _gage_da(d: dict | None, device, dtype):
    from troute_torch.routing.engine import GageDA
    if d is None:
        return None
    return GageDA(
        rows=torch.as_tensor(d["rows"], dtype=torch.int64, device=device),
        obs=torch.as_tensor(d["obs"], dtype=dtype, device=device),
        lastobs_val=torch.as_tensor(d["lastobs_val"], dtype=dtype,
                                    device=device),
        lastobs_time=torch.as_tensor(d["lastobs_time"], dtype=dtype,
                                     device=device),
        decay_coeff=float(d.get("decay_coeff", 120.0)))


def _res_da(d: dict | None, device, dtype):
    """A ``ReservoirDAData`` from a dict of its fields (NumPy arrays; the
    three states as lists of their fields), as ``convert`` carries the
    JAX package's."""
    from troute_torch.convert import from_reservoir_da
    if d is None:
        return None
    states = {"hybrid_state0": ("persisted_outflow", "update_time",
                                "persistence_index",
                                "persistence_update_time"),
              "rfc_state0": ("timeseries_idx", "update_time"),
              "gl_state0": ("assimilated_outflow", "assimilated_time",
                            "update_time")}
    ns = SimpleNamespace(**{k: (SimpleNamespace(**dict(zip(states[k], v)))
                                if k in states else v)
                            for k, v in d.items()})
    return from_reservoir_da(ns, device=device, dtype=dtype)


def _state(st) -> dict:
    return {f: (None if getattr(st, f) is None else _np(getattr(st, f)))
            for f in st._fields}


def _groups(worlds) -> dict:
    """One group of ranks [0, w) for each world size ``w`` (the default
    group for the full size); every rank creates every group, in order."""
    size = dist.get_world_size()
    out = {}
    for w in sorted(set(worlds)):
        out[w] = (dist.group.WORLD if w == size
                  else dist.new_group(list(range(w))))
    return out


def _global_case(c: dict, group, device):
    """``route_sharded_global`` on a case's global inputs."""
    from troute_torch.parallel.partition import partition_network
    from troute_torch.parallel.sharded_engine import route_sharded_global
    dtype = _dtype(c["dtype"])
    topo = c["topo"]
    part = partition_network(topo, dist.get_world_size(group),
                             c.get("assignment"))
    out = route_sharded_global(
        group, topo, c["chan"], c["res_params"], c["cfg"], c["q0"],
        c["depth0"], c["elev0"], c["qlat"],
        da=_gage_da(c.get("da"), device, dtype),
        res_da=_res_da(c.get("res_da"), device, dtype), part=part,
        dtype=dtype, device=device, exchange=c.get("exchange", "neighbor"))
    return {"fvd": _np(out["flowveldepth"]), "nudge": _np(out["nudge"]),
            "state": _state(out["state"]), "mc_calls": out["mc_calls"],
            "strict_sweeps": out.get("strict_sweeps"),
            "cut_edges": part.cut_edges,
            "rounds": int(part.perm_pairs.shape[0])}


def _shard_case(c: dict, group, device):
    """``route_sharded`` on this rank's row of the JAX package's sharded
    inputs (``c["inp"]``, ``c["res_da"]``: their fields as NumPy arrays,
    ``convert.from_sharded_*`` carrying them); ``c["strict"]`` and
    ``c["accel_lin"]`` select the strict driver and its accelerator."""
    from troute_torch.convert import from_sharded_inputs, from_sharded_res_da
    from troute_torch.parallel.sharded_engine import route_sharded
    dtype = _dtype(c["dtype"])
    rank = dist.get_rank(group)
    inp = from_sharded_inputs(SimpleNamespace(**c["inp"]), rank,
                              device=device, dtype=dtype)
    rda = None
    if c.get("res_da") is not None:
        rda = from_sharded_res_da(SimpleNamespace(**c["res_da"]), rank,
                                  device=device, dtype=dtype)
    res = route_sharded(group, inp, c["dt"], c["nts"],
                        qts_subdivisions=c["qts"], res_da=rda,
                        decay_coeff=c.get("decay_coeff", 120.0),
                        exchange=c.get("exchange", "neighbor"),
                        band_shifts=c["band_shifts"],
                        strict=c.get("strict", False),
                        accel_lin=c.get("accel_lin", 0))
    return {f: (_np(getattr(res, f)) if f != "strict_sweeps"
                else res.strict_sweeps) for f in res._fields}


def _mainstem_case(c: dict, group, device):
    """``routing/hybrid.py:run_mainstem`` with its batch lanes sharded over
    ``group`` (``c["args"]``: its positional arguments)."""
    from troute_torch.routing.hybrid import run_mainstem
    ms = run_mainstem(*c["args"], n_qlat_rows=c.get("n_qlat_rows"),
                      group=group)
    return {"fvd": ms["fvd"], "ids": ms["ids"], "diffusive": ms["diffusive"],
            "n_saves": ms["n_saves"]}


_KINDS = {"global": _global_case, "shard": _shard_case,
          "mainstem": _mainstem_case}


def _run(cases, groups, device) -> list:
    rank = dist.get_rank()
    results = []
    for c in cases:
        if rank >= c["world"]:
            results.append(None)
            continue
        t0 = time.perf_counter()
        res = _KINDS[c["kind"]](c, groups[c["world"]], device)
        _sync(device)
        res["seconds"] = time.perf_counter() - t0
        results.append(res)
    return results


def run_cases(cases: list[dict], device: str = "cpu") -> dict:
    """Run each case on the ranks [0, case["world"]) of the group (every
    rank makes the subgroups first); a case is {"kind": "global", "shard"
    or "mainstem", "world": w, ...} with the inputs ``_global_case``,
    ``_shard_case`` or ``_mainstem_case`` reads.  Returns {"cases": [this
    rank's result (with its host "seconds"), or None where it took no
    part], **_process()}."""
    groups = _groups(c["world"] for c in cases)
    return {"cases": _run(cases, groups, device), **_process()}


def _time_short(case: dict, group, device, reps: int) -> dict:
    """The short driver alone on a "global" case's shard, ``reps`` timed
    runs after the ranks line up at a barrier (ms per step; the inputs
    built beforehand, no outputs collected), one exchange of the initial
    flows and B1 on the rank's boundary rows (ms each, averaged over 24
    calls)."""
    from troute_torch.parallel.partition import partition_network
    from troute_torch.parallel.sharded_engine import build_sharded_inputs
    from troute_torch.parallel.stepped_engine import (_Shard,
                                                      route_sharded_stepped)
    dtype = _dtype(case["dtype"])
    topo, cfg = case["topo"], case["cfg"]
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    part = partition_network(topo, world, case.get("assignment"))
    da = case.get("da") or {}
    inp = build_sharded_inputs(
        part, topo, case["chan"], case["res_params"], case["q0"],
        case["depth0"], {int(r): float(case["elev0"][i]) for i, r in
                         enumerate(topo.reservoir_rows)}, case["qlat"],
        rank=rank, device=device, dtype=dtype, gage_rows=da.get("rows"),
        gage_obs=da.get("obs"), gage_lo_val=da.get("lastobs_val"),
        gage_lo_time=da.get("lastobs_time"))
    exchange = case.get("exchange", "neighbor")
    ms = []
    for _ in range(reps):
        dist.barrier(group)
        _sync(device)
        t0 = time.perf_counter()
        route_sharded_stepped(group, inp, cfg.dt, cfg.nts,
                              qts_subdivisions=cfg.qts_subdivisions,
                              exchange=exchange,
                              band_shifts=part.band_shifts, collect=False)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3 / cfg.nts)
    sh = _Shard(group, inp, None, cfg.dt, cfg.qts_subdivisions, 120.0,
                exchange, part.band_shifts)
    out = dict(ms_step=ms, n_boundary=0 if sh.b is None else
               int(sh.b.shape[0]), exchange_ms=None, boundary_ms=None)
    q = inp.q0
    if sh.has_boundary:
        dist.barrier(group)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(24):
            sh.exchange(q)
        _sync(device)
        out["exchange_ms"] = (time.perf_counter() - t0) * 1e3 / 24
    if sh.b is not None:
        b, ql = sh.b, inp.qlat[0]
        up_b = torch.zeros(b.shape[0], dtype=dtype, device=device)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(24):
            sh.mc(up_b, up_b, q[b], ql[b], sh.chan_b, inp.depth0[b])
        _sync(device)
        out["boundary_ms"] = (time.perf_counter() - t0) * 1e3 / 24
    return out


def run_and_time(cases: list[dict], timed: list[int], device: str,
                 reps: int = 3) -> dict:
    """``run_cases``, the B1 launches it made in this process
    ("launches_cases", to hold against the cases' own MC counts), then
    ``_time_short`` of each case in ``timed`` on that case's ranks."""
    from troute_torch.ops import muskingum_cuda as mcc
    groups = _groups(c["world"] for c in cases)
    before = mcc.LAUNCHES
    results = _run(cases, groups, device)
    launches = mcc.LAUNCHES - before
    rank = dist.get_rank()
    times = {}
    for i in timed:
        c = cases[i]
        if rank < c["world"]:
            times[i] = _time_short(c, groups[c["world"]], device, reps)
    return {"cases": results, "launches_cases": launches, "times": times,
            **_process()}


def cli_main(argv: list[str]) -> dict:
    """``troute_torch.cli.main_v04(argv)`` in this rank, under the group
    ``spawn_ranks`` made (the command line uses a group its caller
    created); "launches" are the B1 launches of the command alone, to
    hold against "mc_calls", the MC solves its ``route_sharded_global``
    calls counted (None where it routed none)."""
    from troute_torch.cli import main_v04
    from troute_torch.ops import muskingum_cuda as mcc
    from troute_torch.parallel import sharded_engine
    real, calls = sharded_engine.route_sharded_global, []

    def counted(*args, **kw):
        out = real(*args, **kw)
        calls.append(out["mc_calls"])
        return out

    sharded_engine.route_sharded_global = counted
    before = mcc.LAUNCHES
    try:
        res = main_v04(argv)
    finally:
        sharded_engine.route_sharded_global = real
    launches = mcc.LAUNCHES - before
    return {"fvd": res["fvd"], "ids": res["ids"],
            "written": [str(p) for p in res["written"]],
            "final_state": res["final_state"],
            "task_times": res["task_times"],
            "diffusive": res["diffusive"],
            "mc_calls": sum(calls) if calls else None,
            **_process(), "launches": launches}

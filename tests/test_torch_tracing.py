"""The port's spans and counters (``troute_torch/tracing.py``): off with
no profiler running, on under ``torch.profiler``, nested by layer with
one request id per top-level call, on the profiler's timeline as
``user_annotation`` events, and without effect on what is routed."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from troute_torch import tracing
from troute_torch.bmi import BmiTroute
from troute_torch.network.topology import NODE_RESERVOIR, build_topology
from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.routing import engine

torch.set_num_threads(1)

N = 47                      # segments 1..N, segment k drains to k // 2
LAKE_SEG = 3                # drains into the lake, the lake into 1
LAKE_ID = 1000
CHAN = dict(dx=1500.0, bw=8.0, tw=24.0, twcc=72.0, n=0.05, ncc=0.1, cs=0.8,
            s0=0.004)
# LkArea, LkMxE, OrificeA, OrificeC, OrificeE, WeirC, WeirE, WeirL, ifd
LAKE = (2.0, 12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 0.9)
ELEV0 = LAKE[4] + (LAKE[1] - LAKE[4]) * LAKE[8]
NTS = 3
STEP_CHILDREN = ["engine.upstream_sum", "engine.mc", "engine.reservoirs",
                 "engine.collect"]


@pytest.fixture(autouse=True)
def _empty():
    tracing.drain()
    yield
    tracing.drain()


def _network():
    """(ids, to-ids, node types) of the segments and the lake: the lake
    sits between segment ``LAKE_SEG`` and its downstream segment."""
    seg = np.arange(1, N + 1, dtype=np.int64)
    down = seg // 2
    down[LAKE_SEG - 1] = LAKE_ID
    ids = np.append(seg, LAKE_ID)
    down = np.append(down, LAKE_SEG // 2)
    node_type = np.zeros(ids.size, np.int8)
    node_type[-1] = NODE_RESERVOIR
    return ids, down, node_type


def _stepped_args():
    ids, down, node_type = _network()
    topo = build_topology(ids, down, node_type, row_order="postorder")
    n = ids.size
    f32 = torch.float32
    net = engine.network_arrays_from_topology(topo, device="cpu")
    chan = engine.ChannelParams.from_arrays(
        device="cpu", dtype=f32, **{k: np.full(n, v) for k, v in CHAN.items()})
    lp = LevelpoolParams.from_array(np.asarray([LAKE]), device="cpu",
                                    dtype=f32)
    cfg = engine.RoutingConfig(dt=300.0, nts=NTS, qts_subdivisions=12,
                               assume_short_ts=True)
    elev0 = torch.full((1,), ELEV0, dtype=f32)
    d0 = torch.zeros(n, dtype=f32)
    d0[net.res_rows] = elev0
    qlat = torch.linspace(0.1, 2.0, n, dtype=f32)[None]
    return (net, chan, lp, cfg, torch.zeros(n, dtype=f32), d0, elev0, qlat)


def _route():
    out = engine.route_stepped(*_stepped_args())
    return [out["flowveldepth"], *out["state"][:3]]


def _bmi():
    bmi = BmiTroute(device="cpu")
    bmi.initialize()
    ids, down, _ = _network()
    seg = ids[:-1]
    push = dict(segment_id=seg, segment_toid=down[:-1],
                waterbody_id=np.asarray([LAKE_ID]),
                waterbody_toid=np.asarray([LAKE_SEG // 2]),
                h0=np.asarray([ELEV0]), qd0=np.zeros(1))
    for name, v in zip(("LkArea", "LkMxE", "OrificeA", "OrificeC",
                        "OrificeE", "WeirC", "WeirE", "WeirL", "ifd"), LAKE):
        push[name] = np.asarray([v])
    for k, v in CHAN.items():
        push[k] = np.full(seg.size, v)
    for name, v in push.items():
        bmi.set_value(name, v)
    bmi.set_value("land_surface_water_source__volume_flow_rate",
                  np.linspace(0.1, 2.0, seg.size))
    return bmi


def _update(bmi=None):
    bmi = bmi or _bmi()
    bmi.update_until(3600.0)
    return [torch.as_tensor(np.asarray(bmi.get_value(name))) for name in (
        "channel_exit_water_x-section__volume_flow_rate",
        "channel_water_flow__speed", "channel_water__mean_depth",
        "lake_water~outgoing__volume_flow_rate", "lake_surface__elevation")]


def _children(recs, i):
    return [r.name for r in recs if r.parent == i]


def test_off_without_a_profiler_records_nothing():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("engine.step") is tracing.span("bmi.ingest")
    with tracing.span("engine.step") as s:
        assert s is None
    tracing.count("cuda.device_allocs", 3)
    assert tracing.device_allocs("cpu") is None
    _route()
    _update()
    assert tracing.records() == [] and tracing.counts() == {}


def test_route_stepped_nests_its_spans_under_one_request(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _route()
        _route()
    recs = tracing.records()
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns
               for r in recs)
    roots = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in roots] == ["engine.route"] * 2
    assert len({recs[i].request for i in roots}) == 2
    for root in roots:
        assert _children(recs, root) == ["engine.step"] * NTS \
            + ["engine.collect"]
        steps = [i for i, r in enumerate(recs)
                 if r.parent == root and r.name == "engine.step"]
        for i in steps:
            assert _children(recs, i) == STEP_CHILDREN
        mine = [r for r in recs if r.request == recs[root].request]
        assert len(mine) == 1 + NTS * (1 + len(STEP_CHILDREN)) + 1
        for r in mine:
            if r.parent is not None:
                p = recs[r.parent]
                assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    # the spans are on the profiler's timeline, inside the route's event
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    routes = [e for e in events if e["name"] == "engine.route"]
    assert len(routes) == 2
    lo, hi = routes[0]["ts"], routes[0]["ts"] + routes[0]["dur"]
    inside = [e["name"] for e in events
              if lo <= e["ts"] and e["ts"] + e["dur"] <= hi]
    for name in ["engine.step"] + STEP_CHILDREN:
        want = 1 + NTS if name == "engine.collect" else NTS
        assert inside.count(name) == want, name


def test_bmi_update_is_one_request_of_ingest_engine_publish():
    bmi = _bmi()
    with profile(activities=[ProfilerActivity.CPU]):
        _update(bmi)
    recs = tracing.records()
    assert recs[0].name == "bmi.update_until" and recs[0].parent is None
    assert _children(recs, 0) == ["bmi.ingest", "engine.route",
                                  "bmi.publish"]
    assert {r.request for r in recs} == {recs[0].request}
    route = [i for i, r in enumerate(recs) if r.name == "engine.route"][0]
    assert _children(recs, route).count("engine.step") == 12


def test_self_ns_takes_the_children_off():
    R = tracing.Record
    recs = [R("a", 0, 100, None, 0), R("b", 10, 30, 0, 0),
            R("c", 40, 90, 0, 0), R("d", 50, 60, 2, 0),
            R("e", 200, 210, None, 1), R("f", 300, None, None, 2)]
    assert tracing.self_ns(recs) == [30, 20, 40, 10, 10, None]


def test_counters_count_only_under_a_profiler():
    tracing.count("x")
    with profile(activities=[ProfilerActivity.CPU]):
        tracing.count("x")
        tracing.count("x", 2)
        tracing.count("y", 0)
        # a CPU tensor has no device allocator to read
        assert tracing.device_allocs("cpu") is None
    tracing.count("x")
    assert tracing.counts() == {"x": 3, "y": 0}


@pytest.mark.parametrize("run", [_route, _update], ids=["route_stepped",
                                                        "bmi"])
def test_results_are_bit_identical_under_a_profiler(run):
    plain = run()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    assert tracing.records()
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_drain_returns_and_forgets():
    with profile(activities=[ProfilerActivity.CPU]):
        _route()
        tracing.count("x")
    recs, counts = tracing.drain()
    assert recs and recs[0].name == "engine.route" and counts == {"x": 1}
    assert tracing.records() == [] and tracing.counts() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        _route()
    # after a drain the indices start again from the first record
    assert tracing.records()[0].parent is None
    assert tracing.records()[1].parent == 0

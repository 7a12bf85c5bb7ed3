"""The cell ``conus_ana.nudged`` on the CPU at a tiny size: a sound run
comes out correct with every number under its limit; a run whose timed
path is broken underneath (lakes not assimilated, gages not nudged, the
hand-off's clocks not re-based, lakes' DA state handed on unchanged) comes
out not correct; the control (the reference in bfloat16) fails the limits; and
the readers of the cell's spans read what the program recorded, and
nothing where it recorded nothing."""

import json

import pytest
import torch

from hydrobench import harness, measure, spans

SEED = 2 ** 31 + 99
CELL = "conus_ana.nudged"
R = tuple       # (name, start_ns, end_ns, parent, request)
MS = 1_000_000


@pytest.fixture
def tiny_da(tiny):
    """``tiny``, with the analysis configuration cut to 1,500 segments, 75
    lakes and 30 gages, and 2 DA spin-up hours."""
    manifest, root, traffic = tiny
    conf = [c for c in manifest["configs"] if c["name"] == "nwm_conus_ana"][0]
    with open(conf["file"]) as f:
        cfg = json.load(f)
    cfg["network"].update(segments=1500, basins=15, lake_per_segments=20)
    cfg["da"]["gages"] = 30
    with open(conf["file"], "w") as f:
        json.dump(cfg, f)
    path = traffic / "nudged.json"
    t = json.loads(path.read_text())
    t["observations"]["da_spinup_units"] = 2
    path.write_text(json.dumps(t))
    return manifest, root, traffic


def run(tiny_da, control=False):
    manifest, root, traffic = tiny_da
    return harness.run(manifest, root, CELL, SEED, 0.05, False, "cpu", 0.0,
                       clock=measure.HostClock(), control=control,
                       traffic_dir=traffic)


def test_sound_run_is_correct(tiny_da):
    r = run(tiny_da)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"hour_p95_ms", "setup_s"}
    assert set(r["checks"]) == {"q_max_rel", "off_share", "basin_q_rel",
                                "da_state_gap", "state_gap"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def _fault(monkeypatch, kind):
    from troute_torch.routing import engine
    route, handoff = engine.route_stepped, engine.da_handoff

    def level_pool_only(*a, res_da=None, **kw):
        if res_da is not None:
            res_da = res_da._replace(
                wbody_type=torch.ones_like(res_da.wbody_type))
        return route(*a, res_da=res_da, **kw)

    def no_nudge(*a, da=None, **kw):
        if da is not None:
            nan = float("nan")
            da = da._replace(obs=torch.full_like(da.obs, nan),
                             lastobs_val=torch.full_like(da.lastobs_val, nan))
        return route(*a, da=da, **kw)

    def clocks_kept(da, res_da, state, steps, seconds):
        return handoff(da, res_da, state, steps, 0.0)

    def lakes_kept(da, res_da, state, steps, seconds):
        nda, nres = handoff(da, res_da, state, steps, seconds)
        return nda, nres._replace(hybrid_state0=res_da.hybrid_state0)

    if kind == "level_pool_only":
        monkeypatch.setattr(engine, "route_stepped", level_pool_only)
    elif kind == "no_nudge":
        monkeypatch.setattr(engine, "route_stepped", no_nudge)
    elif kind == "clocks_kept":
        monkeypatch.setattr(engine, "da_handoff", clocks_kept)
    else:
        monkeypatch.setattr(engine, "da_handoff", lakes_kept)


@pytest.mark.parametrize("kind", ["level_pool_only", "no_nudge",
                                  "clocks_kept", "lakes_kept"])
def test_a_broken_timed_path_is_not_correct(tiny_da, monkeypatch, kind):
    _fault(monkeypatch, kind)
    r = run(tiny_da)
    assert not r["correct"] and r["failed"] >= 1


def test_the_control_fails_the_limits(tiny_da):
    r = run(tiny_da, control=True)
    limits = harness.cell(tiny_da[0], CELL, tiny_da[1],
                          tiny_da[2])[1]["judge"]["limits"]
    for unit, nums in r["control"].items():
        assert any(v > limits[c] for c, v in nums.items()), unit


def test_a_program_without_the_hand_off_fails_at_set_up(tiny_da,
                                                       monkeypatch):
    from troute_torch.routing import engine
    monkeypatch.delattr(engine, "da_handoff")
    with pytest.raises(harness.RunError, match="hand-off"):
        run(tiny_da)


# two steps of one hour, each with its reservoirs (and their DA) and its
# nudging
ANA = [R(("engine.route", 0, 100 * MS, None, 0)),
       R(("engine.step", 0, 8 * MS, 0, 0)),
       R(("engine.reservoirs", 1 * MS, 5 * MS, 1, 0)),
       R(("engine.reservoir_da", 2 * MS, 4 * MS, 2, 0)),
       R(("engine.nudge", 5 * MS, 6 * MS, 1, 0)),
       R(("engine.step", 10 * MS, 20 * MS, 0, 0)),
       R(("engine.reservoirs", 11 * MS, 17 * MS, 5, 0)),
       R(("engine.reservoir_da", 12 * MS, 16 * MS, 6, 0)),
       R(("engine.nudge", 17 * MS, 20 * MS, 5, 0)),
       R(("engine.da_handoff", 100 * MS, 101 * MS, None, 1))]
COUNTS = {"engine.nudge_lanes": 60, "engine.reservoir_da_lanes": 10}


@pytest.mark.parametrize("name, want", [("nudge.host_ms.ana", 2.0),
                                        ("reservoir_da.host_ms.ana", 3.0),
                                        ("engine.step_host_ms.ana", 9.0)])
def test_the_analysis_readers_on_hand_made_records(monkeypatch, capsys,
                                                   name, want):
    monkeypatch.setattr(spans, "program", lambda: (ANA, COUNTS))
    assert harness.load_metric(name).read(None) == pytest.approx(want)
    if name == "nudge.host_ms.ana":
        assert "30.0 gage lanes a step" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["nudge.host_ms.ana",
                                  "reservoir_da.host_ms.ana",
                                  "engine.step_host_ms.ana"])
@pytest.mark.parametrize("recs", [None, [R(("other", 0, 5, None, 0))]])
def test_the_analysis_readers_read_nothing_without_their_spans(
        monkeypatch, name, recs):
    got = None if recs is None else (recs, {})
    monkeypatch.setattr(spans, "program", lambda: got)
    assert harness.load_metric(name).read(None) is None

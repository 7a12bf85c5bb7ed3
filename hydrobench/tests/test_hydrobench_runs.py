"""Whole runs of the harness on the CPU at a tiny size: a sound run comes
out correct, and a run whose timed path is broken underneath comes out
not correct, once for each fault a cell can have (a step that returns its
state unchanged, half of the segments left out, one answer altered where
it is produced; no cell spans chips, so no exchange can be left out).
Then the control (the reference in bfloat16) fails the limits, and a new
configuration file is found by its name alone."""

import json

import numpy as np
import pytest
import torch

from hydrobench import harness, measure

SEED = 2 ** 31 + 99


def run(tiny, workload, control=False):
    manifest, root, traffic = tiny
    return harness.run(manifest, root, workload, SEED, 0.05, False, "cpu",
                       0.0, clock=measure.HostClock(), control=control,
                       traffic_dir=traffic)


@pytest.mark.parametrize("workload", ["conus_short.steady",
                                      "nextgen_vpu_bmi.hourly"])
def test_sound_run_is_correct_and_reports_the_cells_metrics(tiny, workload):
    r = run(tiny, workload)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    manifest = tiny[0]
    want = {m["name"] for m in harness.metrics_of(manifest, "end_to_end",
                                                  workload)}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def _stepped_fault(kind):
    from troute_torch.routing import engine
    real = engine.route_stepped

    def broken(net, chan, lp, cfg, q0, d0, e0, qlat, *a, **kw):
        out = real(net, chan, lp, cfg, q0, d0, e0, qlat, *a, **kw)
        fvd, st = out["flowveldepth"], out["state"]
        if kind == "unchanged":
            fvd = torch.stack([q0, torch.zeros_like(q0), d0], -1)[None] \
                .repeat(fvd.shape[0], 1, 1)
            st = st._replace(q=q0, depth=d0, res_elev=e0)
        elif kind == "half":
            fvd = fvd.clone()
            fvd[:, ::2, 0], fvd[:, ::2, 2] = q0[::2], d0[::2]
            q, d = st.q.clone(), st.depth.clone()
            q[::2], d[::2] = q0[::2], d0[::2]
            st = st._replace(q=q, depth=d)
        elif kind == "altered":
            fvd = fvd.clone()
            fvd[fvd.shape[0] // 2, int(fvd[0, :, 0].argmax()), 0] *= 1.5
        out["flowveldepth"], out["state"] = fvd, st
        return out
    return engine, broken


def _bmi_fault(kind):
    from troute_torch.bmi import bmi_troute
    real = bmi_troute.BmiTroute.update_until
    names = ("channel_exit_water_x-section__volume_flow_rate",
             "channel_water__mean_depth")

    def broken(self, until):
        if kind == "unchanged":
            if not self._network_ready:
                self._build_network()
            self._time = until
            return
        before = {k: np.asarray(self._values[k]).copy() for k in names}
        real(self, until)
        for k in names:
            v = np.asarray(self._values[k]).copy()
            if kind == "half" and before[k].size == v.size:
                v[::2] = before[k][::2]
            elif kind == "altered" and k == names[0]:
                v[int(np.argmax(v))] *= 1.5
            self._values[k] = v
    return bmi_troute.BmiTroute, broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", ["conus_short.steady",
                                      "nextgen_vpu_bmi.hourly"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, workload,
                                            kind):
    if workload.startswith("conus"):
        owner, broken = _stepped_fault(kind)
        monkeypatch.setattr(owner, "route_stepped", broken)
    else:
        owner, broken = _bmi_fault(kind)
        monkeypatch.setattr(owner, "update_until", broken)
    r = run(tiny, workload)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("workload", ["conus_short.steady",
                                      "nextgen_vpu_bmi.hourly"])
def test_the_control_fails_the_limits(tiny, workload):
    r = run(tiny, workload, control=True)
    cfg = harness.cell(tiny[0], workload, tiny[1], tiny[2])[1]
    limits = cfg["judge"]["limits"]
    for unit, nums in r["control"].items():
        assert any(v > limits[c] for c, v in nums.items()), unit


def test_a_new_configuration_is_found_by_its_name(tiny, tmp_path):
    manifest, root, traffic = tiny
    src = [c for c in manifest["configs"] if c["name"] == "nwm_conus_short"]
    cfg = json.loads(open(src[0]["file"]).read())
    cfg["name"] = "small_region_short"
    cfg["network"].update(segments=900, basins=20)
    path = tmp_path / "small_region_short.json"
    path.write_text(json.dumps(cfg))
    manifest["configs"].append(dict(src[0], name="small_region_short",
                                    file=str(path)))
    manifest["workloads"].append(dict(
        name="small_region_short.steady", config="small_region_short",
        traffic="steady", chips=1, why="test"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "conus_short.steady" in m.get("workloads", ()):
            m["workloads"].append("small_region_short.steady")
    r = run(tiny, "small_region_short.steady")
    assert r["correct"] and "hour_p95_ms" in r["metrics"]

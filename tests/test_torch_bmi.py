"""The port's BMI components (``troute_torch/bmi``) against the JAX
package's (``troute_tpu/bmi``), given the same pushes.

The five cases of ``tests/test_bmi.py`` that need no reference data keep
their own assertions, and each is held to the JAX BMI on the same pushes
at rtol 1e-5 and atol 1e-7, as ``test_bmi.py:144`` holds its strict case
(both route MC in float32, with different ``pow`` implementations).  The
config-driven BMI with hybrid routing and coastal transport runs on
``test_torch_hybrid.write_hybrid_domain``'s files, port against JAX over 3
updates, with the two physical assertions of ``test_bmi.py:277-280``; its
flows at the f32 bar of ``test_torch_cli.py`` (float32 MC in both; the
diffusive mainstem is float64 and inherits the tributaries' float32
differences).  The DA-forcing BMI on self-written TimeSlice, RFC, lastobs
and lite-restart files must stage arrays equal to JAX's, and its
transport arrays nudge the routing BMI as JAX's do.  The state hand-over
(``convert.from_bmi_state``): 2 updates in JAX and 2 more in the port
against 4 in JAX, at rtol 1e-5 and atol 1e-7 on the MC flows and the f32
bar on the mainstem.  The pushed-id row map, which the BMI builds with the
network and reuses every update: outputs bit for bit those of a fresh
``positions_of`` lookup over a direct ``route_stepped`` call, a new map
after every push of the ids, and JAX's outputs after an in-place one.
"""

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from test_bmi import _push_network
from test_levelpool import (EXPECTED_FINAL_ELEVATION, EXPECTED_FINAL_OUTFLOW,
                            INFLOWS, LP, ROUTING_PERIOD)
from test_torch_cli import f32_bar
from test_torch_hybrid import T0, hybrid_config, write_hybrid_domain
from test_torch_io import _write_timeslice
from troute_torch import convert
from troute_torch.bmi import BmiTroute
from troute_torch.bmi import codec as tcodec
from troute_torch.bmi.bmi_daforcing import BmiDAforcing as TDAforcing
from troute_torch.bmi.bmi_reservoirs import BmiReservoir as TReservoir
from troute_torch.network.builder import positions_of
from troute_torch.network.topology import NODE_RESERVOIR, build_topology
from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.routing import engine
from troute_tpu.bmi import BmiTrouteTpu
from troute_tpu.bmi import codec as jcodec
from troute_tpu.bmi.bmi_daforcing import BmiDAforcing as JDAforcing
from troute_tpu.bmi.bmi_reservoirs import BmiReservoir as JReservoir

torch.set_num_threads(1)

Q = "channel_exit_water_x-section__volume_flow_rate"
TOL = dict(rtol=1e-5, atol=1e-7)


def _pair():
    return BmiTroute(device="cpu"), BmiTrouteTpu()


def test_bmi_metadata_and_step():
    outs = []
    for bmi in _pair():
        bmi.initialize()
        assert "segment_id" in bmi.get_input_var_names()
        assert Q in bmi.get_output_var_names()
        _push_network(bmi, [1, 2, 3, 4], [2, 3, 4, 0], 4)
        bmi.set_value("land_surface_water_source__volume_flow_rate",
                      np.full(4, 1.5))
        bmi.update()
        q1 = bmi.get_value(Q)
        assert q1.shape == (4,) and np.isfinite(q1).all() and q1.max() > 0
        assert bmi.get_current_time() == bmi.get_time_step()
        for _ in range(40):
            bmi.update()
        q = bmi.get_value(Q)
        # steady state: outlet approaches the 4 * 1.5 lateral total
        assert q[-1] == pytest.approx(6.0, rel=0.05)
        outs.append((q1, q, bmi.get_component_name()))
    assert outs[0][2].startswith("troute_torch")
    for g, w in zip(outs[0][:2], outs[1][:2]):
        np.testing.assert_allclose(g, w, **TOL)


def test_bmi_domain_split():
    """Upper instance's outlet flows feed the lower instance via
    upstream_fvd; the split matches the whole domain within 5%."""
    dt, n_steps = 300.0, 30
    res = []
    for cls in (lambda: BmiTroute(device="cpu"), BmiTrouteTpu):
        whole, upper, lower = cls(), cls(), cls()
        for bmi in (whole, upper, lower):
            bmi.initialize()
        _push_network(whole, [1, 2, 3, 4, 5, 6], [2, 3, 4, 5, 6, 0], 6)
        whole.set_value("land_surface_water_source__volume_flow_rate",
                        np.full(6, 1.0))
        _push_network(upper, [1, 2, 3], [2, 3, 999], 3)
        upper.set_value("land_surface_water_source__volume_flow_rate",
                        np.full(3, 1.0))
        _push_network(lower, [3, 4, 5, 6], [4, 5, 6, 0], 4)
        lower.set_value("land_surface_water_source__volume_flow_rate",
                        np.asarray([0.0, 1.0, 1.0, 1.0]))
        for k in range(n_steps):
            t = (k + 1) * dt
            whole.update_until(t)
            upper.update_until(t)
            q_up = upper.get_value(Q)
            lower.set_value("upstream_id", np.asarray([3], np.int64))
            lower.set_value("upstream_fvd",
                            np.asarray([[q_up[-1], 0.0, 0.0]]))
            lower.update_until(t)
        q_whole, q_split = whole.get_value(Q), lower.get_value(Q)
        assert q_split[-1] == pytest.approx(q_whole[-1], rel=0.05)
        res.append((q_whole, q_split))
    for g, w in zip(*res):
        np.testing.assert_allclose(g, w, **TOL)


def test_bmi_strict_mode(tmp_path):
    """``assume_short_ts: False`` routes each update through ``route()``'s
    fixed-point form: the result differs from short steps and equals the
    port's level scan of the same step (rtol 1e-5, atol 1e-7), and JAX's
    strict BMI."""
    from troute_torch.network.topology import build_topology
    from troute_torch.ops.levelpool import LevelpoolParams
    from troute_torch.routing import engine

    cfgp = tmp_path / "bmi_strict.yaml"
    yaml.safe_dump({"compute_parameters": {
        "assume_short_ts": False,
        "forcing_parameters": {"dt": 300.0, "nts": 8},
    }}, open(cfgp, "w"))
    outs = {}
    for name, path in (("strict", str(cfgp)), ("short", "")):
        for bmi in _pair():
            bmi.initialize(path)
            _push_network(bmi, [1, 2, 3, 4], [2, 3, 4, 0], 4)
            bmi.set_value("land_surface_water_source__volume_flow_rate",
                          np.full(4, 2.0))
            bmi.update()
            outs[name, type(bmi).__name__] = bmi.get_value(Q)
            if name == "strict" and isinstance(bmi, BmiTroute):
                sweeps = bmi.last_update_counts["strict_sweeps"]
                assert len(sweeps) == 1 and sweeps[0] >= 2
                assert bmi.last_update_counts["mc_calls"] == sweeps[0] + 1
    got = outs["strict", "BmiTroute"]
    assert np.isfinite(got).all()
    assert not np.allclose(got, outs["short", "BmiTroute"])
    topo = build_topology([1, 2, 3, 4], [2, 3, 4, 0])
    net = engine.network_arrays_from_topology(topo, device="cpu",
                                              need_levels=True)
    f32 = torch.float32
    one = np.ones(4)
    cp = engine.ChannelParams.from_arrays(
        device="cpu", dtype=f32, dx=1500.0 * one, bw=8.0 * one,
        tw=24.0 * one, twcc=72.0 * one, n=0.05 * one, ncc=0.1 * one,
        cs=0.8 * one, s0=0.004 * one)
    lp = LevelpoolParams(*[torch.ones(1, dtype=f32)] * 9)
    cfg = engine.RoutingConfig(dt=300.0, nts=1, qts_subdivisions=1,
                               assume_short_ts=False)
    zero = torch.zeros(4, dtype=f32)
    out = engine.route(net, cp, lp, cfg, zero, zero, torch.zeros(1, dtype=f32),
                       torch.full((1, 4), 2.0, dtype=f32))
    order = np.argsort(np.asarray(topo.ids))
    q_ref = out["flowveldepth"].numpy()[0, order, 0]
    np.testing.assert_allclose(got, q_ref, **TOL)
    for name in ("strict", "short"):
        np.testing.assert_allclose(outs[name, "BmiTroute"],
                                   outs[name, "BmiTrouteTpu"], **TOL)


def _reservoir_pair():
    return TReservoir(device="cpu"), JReservoir()


def test_bmi_reservoir_levelpool_golden():
    """The reservoir BMI reproduces the level-pool golden run (reference
    test_compute_kernel.py::test_lp_run), as JAX's does."""
    res = []
    for bmi in _reservoir_pair():
        bmi.initialize()
        for k, v in dict(LkArea=LP["lake_area"], LkMxE=LP["max_depth"],
                         OrificeA=LP["orifice_area"],
                         OrificeC=LP["orifice_coefficient"],
                         OrificeE=LP["orifice_elevation"],
                         WeirC=LP["weir_coefficient"],
                         WeirE=LP["weir_elevation"],
                         WeirL=LP["weir_length"],
                         dam_length=LP["dam_length"],
                         lake_surface__elevation=LP["water_elevation"],
                         res_type=1, time_step=ROUTING_PERIOD).items():
            bmi.set_value(k, [v])
        for q in INFLOWS:
            bmi.set_value("lake_water~incoming__volume_flow_rate", [float(q)])
            bmi.update()
        out = bmi.get_value("lake_water~outgoing__volume_flow_rate")[0]
        elev = bmi.get_value("lake_surface__elevation")[0]
        assert out == pytest.approx(EXPECTED_FINAL_OUTFLOW, rel=1e-4)
        assert elev == pytest.approx(EXPECTED_FINAL_ELEVATION, rel=1e-5)
        res.append((out, elev))
    np.testing.assert_allclose(res[0], res[1], **TOL)


def test_bmi_reservoir_rfc():
    """An RFC-type reservoir follows the forecast series, as JAX's does;
    then a USGS persistence reservoir on observations."""
    series = np.linspace(10.0, 20.0, 30)
    res = []
    for bmi in _reservoir_pair():
        bmi.initialize()
        for k, v in dict(LkArea=15.0, LkMxE=9.96, OrificeA=1.0,
                         OrificeC=0.1, OrificeE=7.733, WeirC=0.4,
                         WeirE=9.626, WeirL=10.0, dam_length=10.0,
                         res_type=4, time_step=300.0).items():
            bmi.set_value(k, [v])
        bmi.set_value("lake_surface__elevation", [9.7])
        bmi.set_value("rfc_timeseries_discharges", series)
        bmi.set_value("synthetic_flag", np.zeros(30))
        bmi.set_value("rfc_total_counts", [30])
        bmi.set_value("rfc_da_timestep", [3600.0])
        bmi.set_value("rfc_timeseries_idx", [2])
        bmi.set_value("lake_water~incoming__volume_flow_rate", [12.0])
        bmi.update()
        out = bmi.get_value("lake_water~outgoing__volume_flow_rate")[0]
        assert out == pytest.approx(series[3], rel=1e-9)
        elev = bmi.get_value("lake_surface__elevation")[0]
        bmi.set_value("res_type", [2])
        bmi.set_value("gage_observations", [14.0, np.nan, 15.5])
        bmi.set_value("gage_time", [-600.0, 0.0, 900.0])
        bmi.update_until(bmi.get_current_time() + 1200.0)
        res.append((out, elev,
                    bmi.get_value("lake_water~outgoing__volume_flow_rate")[0],
                    bmi.get_value("lake_surface__elevation")[0]))
    np.testing.assert_allclose(res[0], res[1], **TOL)


def test_bmi_needs_a_card_or_the_cpu(monkeypatch):
    """Without ``device="cpu"`` the routing and reservoir BMIs want a CUDA
    device and never pick the CPU by themselves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (BmiTroute, TReservoir):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls()


# ------------------------------------------------ BMI from files, hybrid

@pytest.fixture(scope="module")
def hybrid_files(tmp_path_factory):
    base = tmp_path_factory.mktemp("bmi_hybrid")
    dom = write_hybrid_domain(base)
    cfg = hybrid_config()
    cfg["compute_parameters"]["forcing_parameters"]["nts"] = 36
    p = base / "bmi.yaml"
    yaml.safe_dump(cfg, open(p, "w"))
    return p, dom


def _from_files(bmi, path, tw, coastal):
    bmi.initialize(str(path))
    ids = bmi.get_value("segment_id")
    bmi.set_value("land_surface_water_source__volume_flow_rate",
                  np.full(ids.size, 0.3))
    if coastal:
        bmi.set_value("depthArray_coastal", np.full(6, 4.0))
        bmi.set_value("timeArray_coastal", np.arange(6) * 3600.0)
        bmi.set_value("nTimes_coastal", np.array([6]))
        bmi.set_value("stationArray_coastal", np.array([tw], np.int64))
        bmi.set_value("nStations_coastal", np.array([1]))
        bmi.set_value("coastal_timeRef", np.zeros(1))
    return ids


def test_bmi_from_files_hybrid_coastal(hybrid_files):
    """Config-driven BMI with hybrid routing and coastal depth pushed as
    transport arrays (the shape of ``test_bmi.py:203-280``): a 4 m pool
    at the tailwater throttles its flow and changes its depth.  The pool
    stands at the second tree's tailwater: at the first tree's, after 3 h
    it raises the tailwater's flow instead, in the JAX package as in the
    port, and there the JAX test's assertion on the flow would not hold
    in either."""
    path, dom = hybrid_files
    tw = dom["tailwaters"][1]
    res = {}
    for coastal in (False, True):
        for bmi in _pair():
            ids = _from_files(bmi, path, tw, coastal)
            for h in (1, 2, 3):
                bmi.update_until(h * 3600.0)
            q, d = bmi.get_value(Q), bmi.get_value(
                "channel_water__mean_depth")
            assert np.isfinite(q).all() and np.isfinite(d).all()
            k = int(np.flatnonzero(ids == tw)[0])
            res[coastal, type(bmi).__name__] = (q, d, float(q[k]),
                                                float(d[k]))
    for name in ("BmiTroute", "BmiTrouteTpu"):
        q_no, d_no = res[False, name][2:]
        q_co, d_co = res[True, name][2:]
        assert q_co < q_no - 0.1
        assert abs(d_co - d_no) > 0.05
    for coastal in (False, True):
        for g, w in zip(res[coastal, "BmiTroute"][:2],
                        res[coastal, "BmiTrouteTpu"][:2]):
            f32_bar(g, w)


def test_from_bmi_state_hands_over(hybrid_files):
    """2 updates in JAX, then 2 in the port from JAX's state and values
    (``convert.from_bmi_state``), against 4 updates in JAX."""
    path, dom = hybrid_files
    tw = dom["tailwaters"][0]
    ref = BmiTrouteTpu()
    ids = _from_files(ref, path, tw, coastal=True)
    half = BmiTrouteTpu()
    _from_files(half, path, tw, coastal=True)
    for h in (1, 2):
        ref.update_until(h * 3600.0)
        half.update_until(h * 3600.0)
    port = BmiTroute(device="cpu")
    port.initialize(str(path))
    convert.from_bmi_state(half, port)
    assert port.get_current_time() == 7200.0
    for h in (3, 4):
        ref.update_until(h * 3600.0)
        port.update_until(h * 3600.0)
    ms = np.isin(ids, dom["mainstem_ids"])
    for name in (Q, "channel_water__mean_depth"):
        got, want = port.get_value(name), ref.get_value(name)
        np.testing.assert_allclose(got[~ms], want[~ms], **TOL)
        f32_bar(got[ms], want[ms])
    hyb = convert.from_hybrid_domain(half._hyb)
    assert hyb.reaches == port._hyb.reaches
    np.testing.assert_array_equal(hyb.ds_reach, port._hyb.ds_reach)


# ------------------------------------------------------------ DA forcing

def test_codec_roundtrip():
    df = pd.DataFrame(
        np.arange(6, dtype=float).reshape(2, 3),
        index=["08158000", "0815900A"],
        columns=pd.date_range("2021-08-23", periods=3, freq="15min"))
    t0 = pd.Timestamp("2021-08-23")
    got = tcodec.time_stations_from_df(df, t0)
    want = jcodec.time_stations_from_df(df, t0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    secs, nd, codes, lens, ns = got
    assert nd == 3 and ns == 2
    flat = tcodec.flatten_array(df)
    np.testing.assert_array_equal(flat, jcodec.flatten_array(df))
    back = tcodec.df_from_arrays(flat, secs, codes, lens, t0)
    pd.testing.assert_frame_equal(
        back, jcodec.df_from_arrays(flat, secs, codes, lens, t0))
    assert list(back.index) == list(df.index)
    np.testing.assert_allclose(back.to_numpy(), df.to_numpy())
    assert (back.columns == df.columns).all()
    lo = tcodec.disassemble_lastobs(["01", "0002"], [-60.0, -120.0],
                                    [3.0, 4.0])
    pd.testing.assert_frame_equal(tcodec.assemble_lastobs(*lo),
                                  jcodec.assemble_lastobs(*lo))


GAGES = ["01234567", "07654321", "0999"]


def _write_da_files(base, rng):
    """USGS and USACE TimeSlice files over t0 - 1 h .. t0 + 1 h, an RFC
    forecast file, a lastobs file and lite restarts."""
    from troute_torch.io.output import write_lastobs_nc
    from troute_torch.io.restart import write_lite_restart
    for kind, gages in (("usgs", GAGES), ("usace", ["ACE01", "ACE02"])):
        (base / kind).mkdir()
        for k in range(-4, 5):
            when = T0 + pd.Timedelta(minutes=15 * k)
            stamp = when.strftime("%Y-%m-%d_%H:%M:%S")
            q = rng.uniform(1.0, 9.0, len(gages))
            name = f"{stamp}.15min.{kind}TimeSlice.ncdf"
            _write_timeslice(base / kind / name, [stamp] * len(gages), gages,
                             q, [100] * len(gages))
    (base / "rfc").mkdir()
    stamp = (T0 + pd.Timedelta(hours=28 - 3)).strftime("%Y-%m-%d_%H")
    with h5py.File(base / "rfc" / f"{stamp}.60min.ABCD1.RFCTimeSeries.ncdf",
                   "w") as f:
        f["discharges"] = rng.uniform(1, 9, 30).astype(np.float32)
        f["synthetic_values"] = np.zeros(30, np.int8)
        f["totalCounts"] = np.array([30], np.int32)
        f["observedCounts"] = np.array([12], np.int32)
        f["timeSteps"] = np.array([3600], np.int32)
    write_lastobs_nc(base / "lastobs.nc", np.asarray(GAGES, dtype=object),
                     np.array([-600.0, -1200.0, -60.0]),
                     np.array([4.0, 5.0, 6.0]), T0)
    (base / "restart").mkdir()
    (base / "lr_out").mkdir()
    ids = np.arange(1, 5)
    write_lite_restart(base / "restart", T0, pd.DataFrame(
        {"qu0": rng.uniform(0, 5, 4), "qd0": rng.uniform(0, 5, 4),
         "h0": rng.uniform(0, 2, 4)}, index=ids), pd.DataFrame(
        {"qd0": [1.0], "h0": [10.0]}, index=[7]))


def _da_config(base):
    cfg = {
        "compute_parameters": {
            "restart_parameters": {
                "start_datetime": "2021-08-23_13:00",
                "lite_channel_restart_file":
                    "restart/channel_restart_202108231300",
                "lite_waterbody_restart_file":
                    "restart/waterbody_restart_202108231300"},
            "forcing_parameters": {"dt": 300, "nts": 12},
            "data_assimilation_parameters": {
                "usgs_timeslices_folder": "usgs",
                "usace_timeslices_folder": "usace",
                "timeslice_lookback_hours": 24, "qc_threshold": 1.0,
                "streamflow_da": {"streamflow_nudging": True,
                                  "lastobs_file": "lastobs.nc",
                                  "lastobs_output_folder": "lastobs_out"},
                "reservoir_da": {
                    "reservoir_persistence_da": {
                        "reservoir_persistence_usgs": True,
                        "reservoir_persistence_usace": True},
                    "reservoir_rfc_da": {
                        "reservoir_rfc_forecasts": True,
                        "reservoir_rfc_forecasts_time_series_path": "rfc",
                        "reservoir_rfc_forecasts_offset_hours": 28}}}},
        "output_parameters": {
            "lite_restart": {"lite_restart_output_directory": "lr_out"}}}
    p = base / "da.yaml"
    yaml.safe_dump(cfg, open(p, "w"))
    return p


@pytest.fixture(scope="module")
def da_pair(tmp_path_factory):
    """The DA-forcing BMI of each package, initialized on the same files
    (written once per package from one seed)."""
    out = []
    for name, cls in (("da_torch", TDAforcing), ("da_jax", JDAforcing)):
        base = tmp_path_factory.mktemp(name)
        _write_da_files(base, np.random.default_rng(11))
        bmi = cls()
        bmi.initialize(str(_da_config(base)))
        out.append((bmi, base))
    return out


def test_daforcing_stages_jax_arrays(da_pair):
    (tb, tbase), (jb, jbase) = da_pair
    assert set(tb._values) == set(jb._values)
    for k in jb._values:
        g, w = tb.get_value(k), jb.get_value(k)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    n_st = int(tb.get_value("nStations_usgs")[0])
    assert n_st == 3 and int(tb.get_value("nDates_usgs")[0]) > 0
    assert int(tb.get_value("nStations_reservoir_usace")[0]) == 2
    assert tb.get_value("rfc_totalCounts").tolist() == [30]
    assert tb.get_value("q0_Array").size == 4 * 4
    assert tb.get_component_name().startswith("DAforcing")
    # the lite restart written back by both
    for bmi, base in ((tb, tbase), (jb, jbase)):
        bmi.set_value("q0", np.array([1.0, 2.0, 0.5, 3.0, 4.0, 0.7]))
        bmi.set_value("q0_ids", np.array([101, 102]))
        bmi.set_value("write_lite_restart", np.ones(1))
        bmi.update()
        assert int(bmi.get_value("write_lite_restart")[0]) == 0
    from troute_torch.io.restart import read_lite_restart
    pd.testing.assert_frame_equal(
        read_lite_restart(tbase / "lr_out/channel_restart_202108231300"),
        read_lite_restart(jbase / "lr_out/channel_restart_202108231300"))


def test_daforcing_transport_nudges_routing(da_pair):
    """The DA-forcing BMI's USGS transport arrays, pushed into the routing
    BMI with a gage crosswalk, nudge the gaged segment: port and JAX
    agree, and differ from the run without them."""
    (tb, _), (jb, _) = da_pair
    res = {}
    for da_bmi, bmi in ((tb, BmiTroute(device="cpu")), (jb, BmiTrouteTpu())):
        bmi.initialize()
        _push_network(bmi, [1, 2, 3, 4, 5], [2, 3, 4, 5, 0], 5)
        bmi.set_value("land_surface_water_source__volume_flow_rate",
                      np.full(5, 0.5))
        for k in ("usgs_Array", "datesSecondsArray_usgs",
                  "stationArray_usgs", "stationStringLengthArray_usgs",
                  "lastObs_gageArray", "lastObs_gageStringLengths",
                  "lastObs_timeSince", "lastObs_discharge"):
            name = ("usgs_gage_observation__volume_flow_rate"
                    if k == "usgs_Array" else k)
            bmi.set_value(name, da_bmi.get_value(k))
        codes, lens = tcodec.encode_strings(GAGES[:2])
        bmi.set_value("gage_segment_id", np.array([2, 4], np.int64))
        bmi.set_value("gage_stationArray", codes)
        bmi.set_value("gage_stationStringLengthArray", lens)
        for h in (1, 2):
            bmi.update_until(h * 1800.0)
        res[type(bmi).__name__] = (bmi.get_value(Q),
                                   bmi.get_value("lastObs_discharge"),
                                   bmi.get_value("lastObs_timeSince"))
    for g, w in zip(res["BmiTroute"], res["BmiTrouteTpu"]):
        np.testing.assert_allclose(g, w, **TOL)
    free = BmiTroute(device="cpu")
    free.initialize()
    _push_network(free, [1, 2, 3, 4, 5], [2, 3, 4, 5, 0], 5)
    free.set_value("land_surface_water_source__volume_flow_rate",
                   np.full(5, 0.5))
    for h in (1, 2):
        free.update_until(h * 1800.0)
    assert not np.allclose(free.get_value(Q)[[1, 3]],
                           res["BmiTroute"][0][[1, 3]], rtol=1e-3)


# ----------------------------------------------- the pushed-id row map
INFLOW = "land_surface_water_source__volume_flow_rate"
OUTPUTS = (Q, "channel_water_flow__speed", "channel_water__mean_depth",
           "lake_water~outgoing__volume_flow_rate", "lake_surface__elevation")
CHANNEL = ("dx", "bw", "tw", "twcc", "n", "ncc", "cs", "s0")
LAKE_COLUMNS = ("LkArea", "LkMxE", "OrificeA", "OrificeC", "OrificeE",
                "WeirC", "WeirE", "WeirL", "ifd")


def _shuffled_pushes(seed, n=3000, n_lakes=10):
    """A drainage tree of ``n`` segments with scattered ids, pushed in an
    order drawn from ``seed``, and ``n_lakes`` level-pool lakes, each
    between a segment and that segment's downstream segment."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(10 * n, n, replace=False).astype(np.int64) + 1
    k = np.arange(1, n)
    parent = k - 1 - (rng.random(n - 1) * np.minimum(k, 50)).astype(np.int64)
    down = np.concatenate([[0], ids[parent]])
    seg = rng.choice(k, n_lakes, replace=False)
    lakes = 10**7 + np.arange(n_lakes, dtype=np.int64)
    toid = down.copy()
    toid[seg] = lakes
    perm = rng.permutation(n)
    bw = rng.uniform(2.0, 20.0, n)
    v = dict(segment_id=ids[perm], segment_toid=toid[perm],
             dx=rng.uniform(500.0, 3000.0, n)[perm], bw=bw[perm],
             tw=3.0 * bw[perm], twcc=9.0 * bw[perm],
             n=rng.uniform(0.03, 0.08, n)[perm],
             ncc=rng.uniform(0.06, 0.16, n)[perm],
             cs=rng.uniform(0.5, 1.0, n)[perm],
             s0=rng.uniform(0.001, 0.01, n)[perm],
             waterbody_id=lakes, waterbody_toid=down[seg],
             LkArea=rng.uniform(1.0, 3.0, n_lakes),
             qd0=rng.uniform(0.0, 0.5, n_lakes))
    for name, val in zip(LAKE_COLUMNS[1:],
                         (12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 0.9)):
        v[name] = np.full(n_lakes, val)
    v["h0"] = rng.uniform(8.5, 11.5, n_lakes)
    return v


def _pushed(v):
    bmi = BmiTroute(device="cpu")
    bmi.initialize()
    for name, val in v.items():
        bmi.set_value(name, val.copy())
    return bmi


class _FreshLookup:
    """The BMI's update by hand: the network the pushes describe, each
    pushed array put on its topology rows by a fresh ``positions_of``
    lookup, one direct ``route_stepped`` call per update."""

    def __init__(self, v):
        f32 = np.float32
        self.seg = np.asarray(v["segment_id"], np.int64)
        wb = v["waterbody_id"]
        ids = np.concatenate([self.seg, wb])
        down = np.concatenate([v["segment_toid"], v["waterbody_toid"]])
        node_type = np.concatenate([np.zeros(self.seg.size, np.int8),
                                    np.full(wb.size, NODE_RESERVOIR,
                                            np.int8)])
        self.topo = topo = build_topology(ids, down, node_type)
        n = topo.n_nodes
        rows, _ = positions_of(topo.ids, self.seg)
        chan = {}
        for k in CHANNEL:
            chan[k] = np.ones(n, f32)
            chan[k][rows] = v[k]
        lake_rows, _ = positions_of(topo.ids, wb)
        slot, _ = positions_of(topo.reservoir_rows, lake_rows)
        parm = np.ones((wb.size, 9))
        parm[slot] = np.stack([v[c] for c in LAKE_COLUMNS], 1)
        elev = np.zeros(wb.size, f32)
        elev[slot] = v["h0"]
        q0, d0 = np.zeros(n, f32), np.zeros(n, f32)
        q0[lake_rows] = v["qd0"]
        d0[lake_rows] = elev[slot]
        self.args = (engine.network_arrays_from_topology(topo, device="cpu"),
                     engine.ChannelParams.from_arrays(device="cpu",
                                                      dtype=torch.float32,
                                                      **chan),
                     LevelpoolParams.from_array(parm.astype(f32),
                                                device="cpu",
                                                dtype=torch.float32),
                     engine.RoutingConfig(dt=300.0, nts=12,
                                          qts_subdivisions=1,
                                          assume_short_ts=True,
                                          strict_iterative=False))
        self.state = tuple(torch.as_tensor(a) for a in (q0, d0, elev))

    def update(self, inflow):
        n = self.topo.n_nodes
        rows, found = positions_of(self.topo.ids, self.seg)
        ql = np.zeros((1, n), np.float32)
        ql[0, rows[found]] = inflow[found]
        out = engine.route_stepped(*self.args, *self.state,
                                   torch.as_tensor(ql))
        st = out["state"]
        self.state = (st.q, st.depth, st.res_elev)
        fvd = out["flowveldepth"][-1].numpy()
        rows, found = positions_of(self.topo.ids, self.seg)
        chan = [np.zeros(self.seg.size) for _ in range(3)]
        for j, a in enumerate(chan):
            a[found] = fvd[rows[found], j]
        return chan + [fvd[self.topo.reservoir_rows, 0].astype(np.float64),
                       st.res_elev.numpy().astype(np.float64)]


def _same_update(bmi, lookup, inflow):
    bmi.set_value(INFLOW, inflow)
    bmi.update_until(bmi.get_current_time() + 3600.0)
    want = lookup.update(inflow)
    for name, w in zip(OUTPUTS, want):
        g = bmi.get_value(name)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert np.array_equal(g, w), name
    assert np.abs(want[0]).max() > 0


def test_row_map_outputs_equal_a_fresh_lookup_bit_for_bit():
    v = _shuffled_pushes(5120000005)
    bmi, lookup = _pushed(v), _FreshLookup(v)
    rng = np.random.default_rng(1)
    for _ in range(4):
        _same_update(bmi, lookup, rng.uniform(0.0, 0.0274,
                                              v["segment_id"].size))


def _rename_a_confluence(bmi, v, push):
    """Give a segment that others drain into a new id through ``push``
    (``set_value_at_indices`` or a write through ``get_value_ptr``): the
    pushed order no longer names that topology row."""
    k = int(np.flatnonzero(np.isin(v["segment_id"], v["segment_toid"]))[0])
    new = int(v["segment_id"].max()) + 1
    if push == "set_value_at_indices":
        bmi.set_value_at_indices("segment_id", np.array([k]), np.array([new]))
    else:
        bmi.get_value_ptr("segment_id")[k] = new
    v["segment_id"] = v["segment_id"].copy()
    v["segment_id"][k] = new


@pytest.mark.parametrize("push", ["set_value", "set_value_at_indices",
                                  "get_value_ptr"])
def test_row_map_follows_every_push_of_the_ids(push, monkeypatch):
    """A ``set_value`` of the ids rebuilds the network and the map; an
    in-place write keeps the network and its state, as the JAX package
    does, and only the map follows the new ids."""
    v = _shuffled_pushes(31)
    bmi, lookup = _pushed(v), _FreshLookup(v)
    builds = []
    build = BmiTroute._build_network
    monkeypatch.setattr(BmiTroute, "_build_network",
                        lambda self: (builds.append(1), build(self))[1])
    rng = np.random.default_rng(2)
    n = v["segment_id"].size

    def inflow():
        return rng.uniform(0.0, 0.0274, n)
    _same_update(bmi, lookup, inflow())
    _same_update(bmi, lookup, inflow())
    assert len(builds) == 1          # pushing the inflow rebuilds nothing
    if push == "set_value":
        perm = rng.permutation(n)
        for name in ("segment_id", "segment_toid") + CHANNEL:
            v[name] = v[name][perm]
            bmi.set_value(name, v[name].copy())
        lookup = _FreshLookup(v)
    else:
        _rename_a_confluence(bmi, v, push)
        lookup.seg = v["segment_id"]
    _same_update(bmi, lookup, inflow())
    _same_update(bmi, lookup, inflow())
    assert len(builds) == (2 if push == "set_value" else 1)


@pytest.mark.parametrize("push", ["set_value_at_indices", "get_value_ptr"])
def test_ids_written_in_place_route_as_in_jax(push):
    """The same in-place rename of a segment id, between updates, in the
    port and in the JAX package: every output agrees (rtol 1e-5,
    atol 1e-7) before and after it."""
    v = _shuffled_pushes(53, n=300, n_lakes=3)
    rng = np.random.default_rng(4)
    flows = [rng.uniform(0.0, 0.0274, 300) for _ in range(4)]
    res = []
    for bmi in _pair():
        bmi.initialize()
        w = {k: a.copy() for k, a in v.items()}
        for name, val in w.items():
            bmi.set_value(name, val.copy())
        got = []
        for h, q in enumerate(flows):
            if h == 2:
                _rename_a_confluence(bmi, w, push)
            bmi.set_value(INFLOW, q)
            bmi.update_until(bmi.get_current_time() + 3600.0)
            got.append([bmi.get_value(name) for name in OUTPUTS])
        res.append(got)
    assert np.abs(res[0][-1][0]).max() > 0
    for g_h, w_h in zip(*res):
        for name, g, w in zip(OUTPUTS, g_h, w_h):
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)

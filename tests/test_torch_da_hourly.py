"""NWM's hourly analysis cycle through the port: ``route_stepped`` with
gage nudging and typed reservoir DA, hour after hour, each hour's DA
inputs made by ``engine.da_handoff`` from the hour before.

* Two 1-hour calls joined by the hand-off equal one 2-hour call bit for
  bit, in float64 and float32: flows, nudges and every DA state (the
  clocks are integers of seconds, which both ways hold exactly).
* The hourly loop agrees with the benchmark's plain reference
  (``hydrobench/reference/mc_levelpool_da.py``) within the limits of the
  cell ``conus_ana.nudged``: flows relative 1e-2, values off by over
  1e-4 at most 1e-3 of them, the handed-on DA state relative 1e-5.
* The reference's persistence and RFC DA equal the scalar oracles of
  ``reference_impl.py`` lane by lane in float64 (rel 1e-12), and its
  nudging the oracle network's (``reference_network.py``) ``simple_da``.
* The spans ``engine.nudge``, ``engine.reservoir_da`` and
  ``engine.da_handoff`` and the counters ``engine.nudge_lanes`` and
  ``engine.reservoir_da_lanes`` appear under a profiler with DA, and none
  of them without it.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hydrobench.gen import networks, observations
from hydrobench.reference import mc_levelpool_da as rda
from reference_impl import hybrid_da_ref, rfc_da_ref
from troute_torch import tracing
from troute_torch.network.topology import NODE_RESERVOIR, build_topology
from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.ops.reservoir_da import (GreatLakesDAState, HybridDAState,
                                           RfcDAState)
from troute_torch.routing import engine

torch.set_num_threads(1)

DT = 300.0
STEPS = 12
HOUR = STEPS * DT
NET = dict(segments=600, basins=15, span=4, lake_per_segments=20)
N_GAGES = 30
# one lake in 4 of each of persistence (2, 3), RFC (4) and Great Lakes (6)
TYPES = {"2": 4, "3": 4, "4": 4, "6": 4}
N_OBS = 193                      # 48 h of 15-min observations
N_RFC = 76                       # 28 h before the hour, 48 forecast hours


class Case:
    """A small network with gages and typed lakes, in the program's rows
    (post order) and in the reference's (segment index order), with DA
    inputs for ``hours`` hours in one table each, made from ``seed``."""

    def __init__(self, seed: int, dtype, hours: int = 2, types=None):
        self.dtype = dtype
        net = networks.conus_network(NET, seed)
        self.net = net
        n = net["ids"].size
        node_type = np.zeros(n, np.int8)
        node_type[net["lakes"]] = NODE_RESERVOIR
        topo = build_topology(net["ids"], net["down"], node_type,
                              row_order="postorder")
        self.topo = topo
        canon = np.asarray(topo.ids, np.int64) - 1
        self.canon = torch.as_tensor(canon)
        self.row_of = torch.as_tensor(np.argsort(canon))
        slot = np.searchsorted(net["lakes"],
                               canon[np.asarray(topo.reservoir_rows)])
        self.slot = torch.as_tensor(slot)           # program slot -> lake
        self.lake_slot = torch.as_tensor(np.argsort(slot))
        self.prog_net = engine.network_arrays_from_topology(topo,
                                                            device="cpu")
        self.chan = engine.ChannelParams.from_arrays(
            device="cpu", dtype=dtype,
            **{k: net["chan"][k][canon] for k in networks.CHANNEL_KEYS})
        table = net["lake_params"][slot]
        self.lp = LevelpoolParams.from_array(table, device="cpu", dtype=dtype)

        rng = np.random.default_rng(seed)
        self.gages = observations.choose_gages(n, net["lakes"], N_GAGES,
                                               seed)
        n_lakes = net["lakes"].size
        self.types = observations.lake_types(n_lakes, types or TYPES, seed)
        nts = hours * STEPS
        self.q0 = torch.as_tensor(rng.uniform(0.5, 4.0, n), dtype=dtype)
        self.d0 = torch.as_tensor(rng.uniform(0.05, 0.6, n), dtype=dtype)
        self.e0 = torch.as_tensor(
            networks.initial_elevation(net["lake_params"])
            + rng.uniform(-0.5, 0.3, n_lakes), dtype=dtype)
        self.ql = torch.as_tensor(rng.uniform(0.0, 0.5, (hours, n)),
                                  dtype=dtype)
        # gage observations, missing whole hours and single steps; some
        # gages remember an observation from before the window
        obs = rng.uniform(1.0, 8.0, (nts + 1, N_GAGES))
        obs[rng.random(obs.shape) < 0.3] = np.nan
        obs[:STEPS + 1, :5] = np.nan
        lo_val = np.where(rng.random(N_GAGES) < 0.5,
                          rng.uniform(1.0, 8.0, N_GAGES), np.nan)
        lo_time = np.where(np.isnan(lo_val), np.nan,
                           -DT * rng.integers(1, 20, N_GAGES))
        self.obs, self.lo_val, self.lo_time = obs, lo_val, lo_time
        # persistence observations over the 48 h that end with the window
        t_obs = nts * DT - 900.0 * np.arange(N_OBS)[::-1]
        hobs = rng.uniform(0.5, 6.0, (n_lakes, N_OBS))
        hobs[rng.random(hobs.shape) < 0.2] = np.nan
        hobs[:2, -30:] = np.nan
        series = rng.uniform(-1.0, 8.0, (n_lakes, N_RFC))
        self.t_obs, self.hobs, self.series = t_obs, hobs, series
        self.gl_obs = rng.uniform(2.0, 8.0, (n_lakes, 10))
        self.gl_obs[:, 3:5] = np.nan
        self.gl_time = np.tile(np.arange(10) * 1800.0 - 7200.0,
                               (n_lakes, 1))
        self.gl_clim = rng.uniform(3.0, 6.0, (n_lakes, 12))
        self.months = np.where(np.arange(nts + 1) < 18, 4, 5)
        self.p_ut0 = DT * rng.integers(0, 30, n_lakes)
        self.p_idx0 = rng.integers(0, 14, n_lakes).astype(float)

    def t(self, a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype or self.dtype)

    def program_da(self):
        """(GageDA, ReservoirDAData) of the window, lakes in slot order."""
        s = self.slot.numpy()
        n_res = s.size
        types = self.types[s]
        da = engine.GageDA(
            rows=self.row_of[torch.as_tensor(self.gages)],
            obs=self.t(self.obs), lastobs_val=self.t(self.lo_val),
            lastobs_time=self.t(self.lo_time), decay_coeff=120.0)

        def f(v):
            return self.t(np.broadcast_to(v, (n_res,)))
        res = engine.ReservoirDAData.inactive(
            n_res, STEPS, device="cpu", dtype=self.dtype)._replace(
            wbody_type=torch.as_tensor(types, dtype=torch.int32),
            hybrid_obs=self.t(np.where(((types == 2) | (types == 3))[:, None],
                                       self.hobs[s], np.nan)),
            hybrid_obs_time=self.t(self.t_obs),
            hybrid_state0=HybridDAState(
                persisted_outflow=f(np.nan), update_time=f(0.0),
                persistence_index=self.t(self.p_idx0[s]),
                persistence_update_time=self.t(self.p_ut0[s])),
            rfc_series=self.t(self.series[s]),
            rfc_counts=torch.as_tensor(np.where(types == 4, N_RFC, 0),
                                       dtype=torch.int32),
            rfc_use=torch.as_tensor(types == 4),
            rfc_timestep=f(3600.0), rfc_persist_seconds=f(11 * 86400.0),
            rfc_state0=RfcDAState(
                timeseries_idx=torch.full((n_res,), 28, dtype=torch.int32),
                update_time=f(3600.0)),
            gl_obs=self.t(self.gl_obs[s]), gl_obs_time=self.t(self.gl_time[s]),
            gl_climatology=self.t(self.gl_clim[s]),
            gl_state0=GreatLakesDAState(
                assimilated_outflow=f(np.nan), assimilated_time=f(0.0),
                update_time=f(0.0)),
            month_idx=torch.as_tensor(self.months, dtype=torch.int32))
        return da, res

    def route(self, q, d, e, hour: int, nts: int, da, res):
        cfg = engine.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=STEPS,
                                   assume_short_ts=True)
        return engine.route_stepped(self.prog_net, self.chan, self.lp, cfg,
                                    q, d, e, self.ql[hour:][:, self.canon],
                                    da, res)

    def start(self):
        e = self.e0[self.slot]
        d = self.d0[self.canon].clone()
        d[self.prog_net.res_rows] = e
        return self.q0[self.canon], d, e


def _equal(a, b, what):
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert torch.equal(torch.nan_to_num(a, nan=-7.5),
                       torch.nan_to_num(b, nan=-7.5)), what


def _equal_da(x, y, what):
    names = getattr(type(x), "_fields", range(len(x)))
    for name, a, b in zip(names, x, y):
        if isinstance(a, tuple):
            _equal_da(a, b, f"{what}.{name}")
        elif isinstance(a, torch.Tensor):
            _equal(a, b, f"{what}.{name}")
        else:
            assert a == b, f"{what}.{name}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_two_hours_handed_off_equal_one_two_hour_call(dtype, seed):
    c = Case(seed, dtype)
    da, res = c.program_da()
    q, d, e = c.start()
    whole = c.route(q, d, e, 0, 2 * STEPS, da, res)
    first = c.route(q, d, e, 0, STEPS, da, res)
    da1, res1 = engine.da_handoff(da, res, first["state"], STEPS, HOUR)
    st = first["state"]
    second = c.route(st.q, st.depth, st.res_elev, 1, STEPS, da1, res1)
    _equal(torch.cat([first["flowveldepth"], second["flowveldepth"]]),
           whole["flowveldepth"], "flowveldepth")
    _equal(torch.cat([first["nudge"], second["nudge"]]), whole["nudge"],
           "nudge")
    # both ways handed on to the same next hour
    _equal_da(engine.da_handoff(da1, res1, second["state"], STEPS, HOUR),
              engine.da_handoff(da, res, whole["state"], 2 * STEPS,
                                2 * HOUR), "handed on")
    _equal_da(second["state"]._replace(lastobs_time=None, hybrid=None,
                                       rfc=None, gl=None),
              whole["state"]._replace(lastobs_time=None, hybrid=None,
                                      rfc=None, gl=None), "state")
    # every kind of lane did something
    assert (whole["nudge"] != 0).any()
    assert (whole["state"].rfc.timeseries_idx > 28).any()
    assert torch.isfinite(whole["state"].hybrid.persisted_outflow).any()
    assert torch.isfinite(whole["state"].gl.assimilated_outflow).any()


def test_the_hand_off_re_bases_every_clock_and_keeps_the_months_tail():
    c = Case(5, torch.float64)
    da, res = c.program_da()
    q, d, e = c.start()
    out = c.route(q, d, e, 0, STEPS, da, res)
    st = out["state"]
    nda, nres = engine.da_handoff(da, res, st, STEPS, HOUR)
    _equal(nda.obs, da.obs[STEPS:], "obs")
    _equal(nda.lastobs_val, st.lastobs_val, "lastobs_val")
    _equal(nda.lastobs_time, st.lastobs_time - HOUR, "lastobs_time")
    _equal(nres.hybrid_obs_time, res.hybrid_obs_time - HOUR, "obs time")
    _equal(nres.gl_obs_time, res.gl_obs_time - HOUR, "gl obs time")
    _equal(nres.hybrid_state0.update_time, st.hybrid.update_time - HOUR,
           "hybrid update")
    _equal(nres.hybrid_state0.persisted_outflow, st.hybrid.persisted_outflow,
           "persisted")
    _equal(nres.rfc_state0.timeseries_idx, st.rfc.timeseries_idx, "rfc idx")
    _equal(nres.rfc_state0.update_time, st.rfc.update_time - HOUR, "rfc")
    _equal(nres.gl_state0.assimilated_outflow, st.gl.assimilated_outflow,
           "gl outflow")
    _equal(nres.month_idx, res.month_idx[STEPS:], "months")
    assert nres.month_idx.device.type == "cpu"
    # hour after hour, a month table shorter than the hour keeps its last
    # entry (route_stepped clips to it)
    for _ in range(3):
        nda, nres = engine.da_handoff(nda, nres, st, STEPS, HOUR)
    assert nres.month_idx.tolist() == [5] and nda.obs.shape[0] == 0
    assert engine.da_handoff(None, None, st, STEPS, HOUR) == (None, None)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_one_short_step_with_da_is_the_plain_block_on_cpu(dtype):
    """``_one_short_step`` with DA on the CPU, whose lakes go through the DA
    form of the level-pool wrapper (its plain version for CPU tensors),
    step after step: bit for bit (NaN where NaN) the block it replaced,
    the lakes' inflow gather ``quc[res_rows]``, the plain level pool,
    ``typed_reservoir_dispatch``, out-of-place ``index_put`` of the outflow
    and the depth column into the MC result, then nudging; no launch."""
    from reservoir_da_lanes import plain_dispatch
    from troute_torch.ops import levelpool_cuda
    from troute_torch.ops.levelpool import levelpool_step
    c = Case(6, dtype)
    da, res = c.program_da()
    net, lp = c.prog_net, c.lp
    q, d, e = c.start()
    lo_val, lo_time = da.lastobs_val, da.lastobs_time
    states = (res.hybrid_state0, res.rfc_state0, res.gl_state0)
    ql = c.ql[0][c.canon]
    real = torch.empty(0, dtype=dtype).numpy().dtype.type
    before = (levelpool_cuda.LAUNCHES, levelpool_cuda.DA_LAUNCHES)
    for t in range(1, 5):
        now = float(real(t) * real(DT))
        month = int(res.month_idx[t])
        got = engine._one_short_step(
            q, d, e, lo_val, lo_time, ql, da.obs[t], now, net.upstream,
            c.chan, lp, net.is_reservoir, net.res_rows, da.rows,
            da.decay_coeff, DT, res_da=res, da_states=states, month_i=month,
            uplan=net.uplan, want_raw=True)
        raw = got[-1]
        inflow = engine._upstream_sum_stepped(q, net.upstream,
                                              net.uplan)[net.res_rows]
        lp_out, lp_elev = levelpool_step(e, inflow, inflow,
                                         torch.zeros_like(inflow), DT, lp)
        out, elev, d_scat, *want_states = plain_dispatch(
            res, states, e, inflow, lp_out, lp_elev, now, month, lp, DT)
        is_res = net.is_reservoir
        want_q = torch.where(is_res, q, raw.qdc).index_put((net.res_rows,),
                                                           out)
        want_d = torch.where(is_res, d, raw.depthc).index_put(
            (net.res_rows,), d_scat)
        want_q, nudge, want_lv, want_lt = engine._apply_nudging(
            want_q, da.rows, now, da.decay_coeff, lo_val, lo_time, da.obs[t])
        for k, w in ((0, want_q), (2, want_d), (3, elev), (4, want_lv),
                     (5, want_lt), (6, nudge)):
            _equal(got[k], w, f"step {t} output {k}")
        _equal_da(got[7], tuple(want_states), f"step {t} states")
        q, _, d, e, lo_val, lo_time, _, states = got[:8]
    assert (levelpool_cuda.LAUNCHES, levelpool_cuda.DA_LAUNCHES) == before


def _reference(c, dtype):
    net = c.net
    return rda.Network(
        net["ids"], net["down"], net["chan"], net["lakes"],
        net["lake_params"], c.gages, c.types,
        np.where(c.types == 4, N_RFC, 0), decay_min=120.0,
        lookback_hours=48.0, rfc_step_s=3600.0, rfc_persist_s=11 * 86400.0,
        device="cpu", dtype=dtype)


def _ref_state(ref, c, da, res):
    s = c.lake_slot
    h, r = res.hybrid_state0, res.rfc_state0
    st = ref.state(da.lastobs_val, da.lastobs_time, h.persisted_outflow[s],
                   h.update_time[s], h.persistence_index[s],
                   h.persistence_update_time[s], r.timeseries_idx[s],
                   r.update_time[s])
    obs = ref.hour_obs(da.obs, res.hybrid_obs[s], res.hybrid_obs_time,
                       res.rfc_series[s])
    return st, obs


@pytest.mark.parametrize("seed", [7, 2 ** 32 + 1])
def test_the_hourly_loop_matches_the_plain_reference(seed):
    """Three hours, each handed to the next by the program and by the
    reference on their own; no Great Lakes (the reference has none)."""
    dtype = torch.float32
    c = Case(seed, dtype, hours=3, types={"2": 4, "3": 4, "4": 4})
    ref = _reference(c, dtype)
    da, res = c.program_da()
    q, d, e = c.start()
    st, obs = _ref_state(ref, c, da, res)
    rq, rd, re_ = c.q0, c.d0.clone(), c.e0
    rd[torch.as_tensor(c.net["lakes"])] = c.e0
    tally = rda.Tally()
    for hour in range(3):
        out = c.route(q, d, e, hour, STEPS, da, res)
        want = []
        rq, _, rd, re_, st = ref.run_da(
            rq, rd, re_, c.ql[hour], STEPS, DT, st, obs,
            on_step=lambda t, q_, v_, d_: want.append((q_, v_, d_)))
        fvd = out["flowveldepth"]
        for t, (wq, wv, wd) in enumerate(want):
            tally.flows(fvd[t][:, 0][c.row_of], wq)
            tally.others(fvd[t][:, 1][c.row_of], wv)
            tally.others(fvd[t][:, 2][c.row_of], wd)
        da, res = engine.da_handoff(da, res, out["state"], STEPS, HOUR)
        st = rda.handoff(st, HOUR)
        gap = rda.state_gap(_ref_state(ref, c, da, res)[0], st)
        assert gap <= 1e-5, hour
        s = out["state"]
        q, d, e = s.q, s.depth, s.res_elev
        obs = obs._replace(gage=obs.gage[STEPS:],
                           lake_time=obs.lake_time - HOUR)
    nums = tally.numbers()
    assert nums["q_max_rel"] <= 1e-2 and nums["off_share"] <= 1e-3, nums


def test_the_reference_chain_steps_as_its_single_step():
    """``chain`` (the hour's steps side by side, the DA state walked after)
    against ``step_da`` step by step from the same states, float64: equal
    to rel 1e-12 (a batched solve may take another vector path of ``pow``
    on the CPU)."""
    c = Case(12, torch.float64, types={"2": 3, "3": 3, "4": 3})
    ref = _reference(c, torch.float64)
    da, res = c.program_da()
    st0, obs = _ref_state(ref, c, da, res)
    rng = np.random.default_rng(12)
    n, n_lakes = c.q0.shape[0], c.e0.shape[0]
    qs = torch.as_tensor(rng.uniform(0.5, 4.0, (STEPS, n)))
    ds = torch.as_tensor(rng.uniform(0.05, 0.6, (STEPS, n)))
    es = torch.as_tensor(rng.uniform(10.0, 11.9, (STEPS, n_lakes)))
    *got, got_st = ref.chain(qs, ds, es, c.ql[0], DT, st0, obs)
    st = st0
    for t in range(STEPS):
        q, v, d, _, _, st = ref.step_da(qs[t], ds[t], es[t], c.ql[0], DT, st,
                                        obs, t + 1)
        for g, w in zip(got, (q, v, d)):
            np.testing.assert_allclose(g[t].numpy(), w.numpy(), rtol=1e-12,
                                       atol=1e-12)
    assert rda.state_gap(got_st, st) == 0.0


def _hybrid_lanes(rng, n):
    """Lanes over the persistence DA's branches: searching or not, fresh,
    stale and missing observations, cycle boundaries, the limit."""
    obs = rng.uniform(0.0, 9.0, (n, 40))
    obs[rng.random(obs.shape) < 0.3] = np.nan
    obs[: n // 8] = np.nan
    t_obs = 900.0 * np.arange(40) - 20000.0
    return dict(
        obs=obs, t_obs=t_obs, now=float(rng.choice([300.0, 3600.0, 9000.0])),
        prev=np.where(rng.random(n) < 0.3, np.nan, rng.uniform(0, 9, n)),
        ut=rng.choice([0.0, 3600.0, 1.0e6, -2.0e5, 7200.0], n),
        p_idx=rng.integers(0, 15, n).astype(float),
        p_ut=rng.choice([0.0, 600.0, 1.0e5], n),
        lp_out=rng.uniform(0, 5, n), inflow=rng.uniform(0, 20, n),
        area=rng.uniform(0.01, 3.0, n), elev=rng.uniform(7.0, 12.5, n))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_persistence_matches_the_scalar_oracle(seed):
    rng = np.random.default_rng(seed)
    n = 400
    x = _hybrid_lanes(rng, n)
    t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
         for k, v in x.items()}
    got = rda.hybrid(t["obs"], t["t_obs"], x["now"], t["prev"], t["ut"],
                     t["p_idx"], t["p_ut"], t["lp_out"], t["inflow"], DT,
                     t["area"], torch.full((n,), 12.0),
                     torch.full((n,), 8.0), t["elev"], 48 * 3600.0)
    for i in range(n):
        out, pers, elev, ut, p_idx, p_ut = hybrid_da_ref(
            x["obs"][i], x["t_obs"], x["now"], x["prev"][i], x["p_ut"][i],
            x["p_idx"][i], x["lp_out"][i], x["inflow"][i], DT,
            x["area"][i], 12.0, 8.0, x["elev"][i], 48.0, x["ut"][i])
        want = (out, elev, pers, ut, p_idx, p_ut)
        for k, (g, w) in enumerate(zip(got, want)):
            g = float(g[i])
            assert (math.isnan(g) and math.isnan(w)) \
                or g == pytest.approx(w, rel=1e-12, abs=1e-12), (i, k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_rfc_matches_the_scalar_oracle(seed):
    rng = np.random.default_rng(seed + 10)
    n, m = 400, 30
    series = rng.uniform(-3.0, 9.0, (n, m))
    series[: n // 10, :] = -1.0
    counts = rng.integers(5, m, n)
    idx = np.minimum(rng.integers(0, m, n), counts)
    ut = rng.choice([0.0, 300.0, 3600.0, 9000.0], n)
    rtype = rng.choice([4, 5], n)
    inflow = rng.uniform(0, 10, n)
    elev = rng.uniform(0, 13, n)
    lp_out, lp_elev = rng.uniform(0, 5, n), rng.uniform(8, 12, n)
    area = rng.uniform(0.5, 3.0, n)
    for now, persist in ((600.0, 86400.0), (3600.0, 86400.0),
                         (7200.0, 3600.0)):
        got = rda.rfc(torch.as_tensor(series), torch.as_tensor(counts),
                      torch.as_tensor(idx), torch.as_tensor(ut), 3600.0,
                      persist, torch.as_tensor(rtype), now,
                      torch.as_tensor(inflow), torch.as_tensor(elev),
                      torch.as_tensor(lp_out), torch.as_tensor(lp_elev),
                      torch.as_tensor(area), torch.full((n,), 12.0), DT)
        for i in range(n):
            out, new_elev, new_ut, new_idx = rfc_da_ref(
                True, series[i], int(idx[i]), int(counts[i]), DT, now,
                ut[i], 3600.0, persist, rtype[i], inflow[i], elev[i],
                lp_out[i], lp_elev[i], area[i] * 1e6, 12.0)
            assert float(got[0][i]) == pytest.approx(out, rel=1e-12), i
            assert float(got[1][i]) == pytest.approx(new_elev, rel=1e-12), i
            assert int(got[2][i]) == new_idx and float(got[3][i]) == new_ut


def test_reference_nudging_matches_simple_da():
    """Gage lanes of ``step_da`` against ``simple_da`` as the oracle
    network writes it, from the same model flows."""
    c = Case(9, torch.float64, types={"2": 1000})
    ref = _reference(c, torch.float64)
    da, res = c.program_da()
    st, obs = _ref_state(ref, c, da, res)
    q, d, e = c.q0, c.d0, c.e0
    lo_val, lo_time = c.lo_val.copy(), c.lo_time.copy()
    for t in range(1, 2 * STEPS + 1):
        model = ref.step(q, d, e, c.ql[0], DT)[0][torch.as_tensor(c.gages)]
        q, _, d, e, _, st = ref.step_da(q, d, e, c.ql[0], DT, st, obs, t)
        for gi in range(N_GAGES):
            target, m = c.obs[t, gi], float(model[gi])
            if not math.isnan(target):
                want = target
                lo_val[gi], lo_time[gi] = target, t * DT
            elif math.isnan(lo_val[gi]):
                want = m
            else:
                minutes = (t * DT - lo_time[gi]) / 60.0
                want = m + (lo_val[gi] - m) * math.exp(abs(minutes) / -120.0)
            assert float(q[c.gages[gi]]) == pytest.approx(want, rel=1e-12)
        np.testing.assert_array_equal(st.lastobs_val.numpy(), lo_val)
        np.testing.assert_array_equal(st.lastobs_time.numpy(), lo_time)


def _traced(with_da: bool):
    c = Case(4, torch.float32)
    da, res = c.program_da() if with_da else (None, None)
    q, d, e = c.start()
    tracing.drain()
    with profile(activities=[ProfilerActivity.CPU]):
        out = c.route(q, d, e, 0, STEPS, da, res)
        engine.da_handoff(da, res, out["state"], STEPS, HOUR)
    recs, counts = tracing.drain()
    return c, recs, counts


def test_da_spans_and_counters_under_a_profiler():
    c, recs, counts = _traced(True)
    names = [r.name for r in recs]
    assert names.count("engine.nudge") == STEPS
    assert names.count("engine.reservoir_da") == STEPS
    assert names.count("engine.da_handoff") == 1
    for r in recs:
        if r.name == "engine.nudge":
            assert recs[r.parent].name == "engine.step"
        if r.name == "engine.reservoir_da":
            assert recs[r.parent].name == "engine.reservoirs"
        if r.name == "engine.da_handoff":
            assert r.parent is None
    n_res = int(c.prog_net.res_rows.shape[0])
    assert counts["engine.nudge_lanes"] == N_GAGES * STEPS
    assert counts["engine.reservoir_da_lanes"] == n_res * STEPS


def test_no_da_span_or_counter_without_da():
    _, recs, counts = _traced(False)
    names = {r.name for r in recs}
    assert "engine.step" in names
    assert not names & {"engine.nudge", "engine.reservoir_da",
                        "engine.da_handoff"}
    assert "engine.nudge_lanes" not in counts
    assert "engine.reservoir_da_lanes" not in counts

"""Driver of NWM's hourly analysis-and-assimilation cycle: ``route_stepped``
hour after hour with gage nudging and typed reservoir DA, each hour's DA
inputs made by the program's own hand-off (``engine.da_handoff``) from the
hour before, with that hour's observations and forecasts swapped in.

Set-up is ``stepped``'s (the network, the forcing on the device, the
traffic's ``spinup_units`` hours from a cold start, without DA), then the
DA inputs (``gen/observations.py``): the gages and the lakes' DA types
from the seed, and rings of hourly observation tables whose values scale
the flows that spin-up left; then ``da_spinup_units`` hours with DA from a
cold DA state (no last observation, nothing persisted), which also warms
every shape of the window.  A unit of the window is one hour: one
``route_stepped(..., da=..., res_da=..., collect=True)`` call, then the
hand-off and the next hour's tables; the harness's clock ends it with a
``torch.cuda.synchronize()``.

Each hour's tables: the gage observations of its steps; the persistence
observations of the 48 hours that end with it; the RFC series issued at
its start, which T-Route's ``preprocess_rfc_data`` would start at the
first forecast value with the next advance one time step on (so the RFC
lanes take that index and clock each hour in place of the hand-off's,
which continue the hour before's file).  The gage and persistence DA
state is the hand-off's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hydrobench import harness
from hydrobench.drivers import stepped
from hydrobench.gen import observations


class Driver(stepped.Driver):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        super().__init__(cfg, traffic, seed, device)
        self.da = self.res_da = None

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from troute_torch.routing import engine
        if not hasattr(engine, "da_handoff"):
            raise harness.RunError("the program has no DA hand-off "
                                   "(routing.engine.da_handoff)")
        super().setup()
        # the judge's first hour is the first with DA
        del self.samples["start"]
        self._make_da()
        for j in range(int(self.traffic["observations"]["da_spinup_units"])):
            self.unit(j)
            if j == 0:
                state_in, da_in, res_in, idx, out, nxt = self._last
                self.samples["start"] = (state_in, da_in, res_in,
                                         self.ring[idx], out, nxt)
        self._last = None
        self.window_start = self.state

    def _make_da(self) -> None:
        """The DA inputs of the first DA hour, and the rings of tables."""
        from troute_torch.ops.reservoir_da import HybridDAState, RfcDAState
        from troute_torch.routing import engine

        da, obs = self.cfg["da"], self.traffic["observations"]
        dev, dt = self.device, self.dtype
        net, n = self.net, self.net["ids"].size
        self.gage_canon = observations.choose_gages(
            n, net["lakes"], int(da["gages"]), self.seed)
        self.lake_type = observations.lake_types(
            net["lakes"].size, da["lake_every"], self.seed)
        # the flows the spin-up left, in the reference's order
        q, _, _ = self._start(self.state)
        base_g = q[torch.as_tensor(self.gage_canon, device=dev)]
        base_l = q[torch.as_tensor(net["lakes"], device=dev)]
        lt = torch.as_tensor(self.lake_type, device=dev)
        self.hour_s = self.steps * self.dt
        self.gage_ring = observations.gage_ring(obs, base_g, self.steps,
                                                self.seed)
        # lake tables in the program's slot order (slot s holds lake
        # order[s]); the judge maps them back with lake_slot
        order = torch.argsort(self.lake_slot)
        self.lake_time = observations.obs_times(da, self.hour_s, base_l)
        self.lake_ring = observations.persistence_ring(
            obs, da, base_l, (lt == 2) | (lt == 3), self.hour_s,
            self.seed)[:, order].contiguous()
        self.rfc_ring = observations.rfc_ring(
            obs, da, base_l, lt == 4, self.seed)[:, order].contiguous()
        n_res = base_l.shape[0]
        counts = observations.rfc_counts(da)
        types = lt[order].to(torch.int32)

        def full(v, dtype=dt):
            return torch.full((n_res,), v, dtype=dtype, device=dev)
        nan = float("nan")
        # the file's start: the first forecast value, the next advance one
        # time step on
        self.rfc_start = RfcDAState(
            timeseries_idx=full(int(da["rfc_lookback_hours"]), torch.int32),
            update_time=full(float(da["rfc_step_s"])))
        self.da = engine.GageDA(
            rows=self.row_of_canon[torch.as_tensor(self.gage_canon,
                                                   device=dev)],
            obs=self.gage_ring[0],
            lastobs_val=torch.full((self.gage_canon.size,), nan, dtype=dt,
                                   device=dev),
            lastobs_time=torch.full((self.gage_canon.size,), nan, dtype=dt,
                                    device=dev),
            decay_coeff=float(da["decay_min"]))
        self.res_da = engine.ReservoirDAData.inactive(
            n_res, self.steps, device=dev, dtype=dt)._replace(
            wbody_type=types,
            hybrid_obs=self.lake_ring[0], hybrid_obs_time=self.lake_time,
            hybrid_state0=HybridDAState(
                persisted_outflow=full(nan), update_time=full(0.0),
                persistence_index=full(0.0),
                persistence_update_time=full(0.0)),
            rfc_series=self.rfc_ring[0],
            rfc_counts=torch.where(types == 4, counts, 0).to(torch.int32),
            rfc_use=types == 4, rfc_timestep=full(float(da["rfc_step_s"])),
            rfc_persist_seconds=full(float(da["rfc_persist_days"]) * 86400.0),
            rfc_state0=self.rfc_start,
            obs_lookback_hours=float(da["lookback_hours"]))

    def _route(self, qlat):
        from troute_torch.routing import engine
        q, d, elev = self.state
        return engine.route_stepped(self.program_net, self.chan, self.lp,
                                    self.rcfg, q, d, elev, qlat,
                                    da=self.da, res_da=self.res_da,
                                    collect=self.collect)

    # ------------------------------------------------------------ window
    def unit(self, k: int) -> None:
        from troute_torch.routing import engine
        idx = k % self.ring.shape[0]
        state_in, da_in, res_in = self.state, self.da, self.res_da
        out = self._route(self.ring[idx:idx + 1])
        self.state = self._next(out)
        nxt = engine.da_handoff(da_in, res_in, out["state"], self.steps,
                                self.hour_s)
        j = (k + 1) % self.gage_ring.shape[0]
        self.da = nxt[0]._replace(obs=self.gage_ring[j])
        self.res_da = nxt[1]._replace(
            hybrid_obs=self.lake_ring[j], hybrid_obs_time=self.lake_time,
            rfc_series=self.rfc_ring[j], rfc_state0=self.rfc_start)
        self._last = (state_in, da_in, res_in, idx, out, nxt)

    def after(self, k: int, ms: float) -> None:
        """Keep the hours the judge reads, as ``stepped`` does, with each
        hour's DA inputs and the hand-off's result."""
        self.seen += 1
        state_in, da_in, res_in, idx, out, nxt = self._last
        item = (state_in, da_in, res_in, self.ring[idx], out, nxt)
        for j in range(int(self.cfg["judge"]["random_units"])):
            if self.seen == 1 or self.pick.random() < 1.0 / self.seen:
                self.samples[f"random{j}"] = item
        if ms > self.slowest:
            self.slowest = ms
            self.samples["slowest"] = item
        self._last = None

    def free_program(self) -> None:
        super().free_program()
        self.da = self.res_da = None

    # ------------------------------------------------------------ judge
    def _reference(self, dtype):
        net, da = self.net, self.cfg["da"]
        counts = np.where(self.lake_type == 4, observations.rfc_counts(da),
                          0)
        return self.reference.Network(
            net["ids"], net["down"], net["chan"], net["lakes"],
            net["lake_params"], self.gage_canon, self.lake_type, counts,
            decay_min=float(da["decay_min"]),
            lookback_hours=float(da["lookback_hours"]),
            rfc_step_s=float(da["rfc_step_s"]),
            rfc_persist_s=float(da["rfc_persist_days"]) * 86400.0,
            device=self.device, dtype=dtype)

    def _ref_da(self, ref, da, res_da):
        """A program's (``GageDA``, ``ReservoirDAData``) as the reference's
        (DA state, hour's tables), lakes in the reference's order."""
        s = self.lake_slot
        h, r = res_da.hybrid_state0, res_da.rfc_state0
        st = ref.state(da.lastobs_val, da.lastobs_time,
                       h.persisted_outflow[s], h.update_time[s],
                       h.persistence_index[s], h.persistence_update_time[s],
                       r.timeseries_idx[s], r.update_time[s])
        obs = ref.hour_obs(da.obs, res_da.hybrid_obs[s],
                           res_da.hybrid_obs_time, res_da.rfc_series[s])
        return st, obs

    def judge(self, control: bool = False) -> dict:
        """The compared numbers of each kept hour, as ``stepped`` judges
        them, with the reference's DA: each step from the program's own
        state before it, the DA state carried from step to step by the
        reference alone from the hour's start (the program's hand-off of
        the hour before); for ``basin_q_rel``, the reference free over the
        hour against the judged flows (for the control, its step-by-step
        flows stand in the program's); ``state_gap`` as ``stepped``'s; and
        ``da_state_gap``: the largest relative gap between the DA state
        the program's hand-off gives for the next hour (last observations
        and their times, the persistence and RFC states) and the one the
        reference ends the hour in, handed off by its own clocks (for the
        control: the bfloat16 reference's against the float32's)."""
        rm = self.reference
        ref = self._reference(self.dtype)
        low = self._reference(torch.bfloat16) if control else None
        checks = {}
        for name in sorted(self.samples):
            state_in, da_in, res_in, ql_rows, out, nxt = self.samples[name]
            q0, d0, e0 = self._start(state_in)
            ql = self._canon(ql_rows)
            fvd = out["flowveldepth"]
            qs = torch.stack([q0] + [self._canon(fvd[t][:, 0])
                                     for t in range(self.steps - 1)])
            ds = torch.stack([d0] + [self._canon(fvd[t][:, 2])
                                     for t in range(self.steps - 1)])
            es = torch.stack([e0] + [fvd[t][self.res_rows, 2][self.lake_slot]
                                     for t in range(self.steps - 1)])
            st0, obs = self._ref_da(ref, da_in, res_in)
            *want, want_st = ref.chain(qs, ds, es, ql, self.dt, st0, obs)
            if control:
                lst0, lobs = self._ref_da(low, da_in, res_in)
                *got, got_st = low.chain(qs, ds, es, ql, self.dt, lst0, lobs)
                got = [x.float() for x in got]
            else:
                got = [torch.stack([self._canon(fvd[t][:, f])
                                    for t in range(self.steps)])
                       for f in range(3)]
                got_st = self._ref_da(ref, *nxt)[0]
            keep = ~ref.explained(qs, ds, ql.expand(self.steps, -1), got,
                                  want, self.dt)
            tally = rm.Tally()
            tally.flows(got[0][keep], want[0][keep])
            tally.others(got[1][keep], want[1][keep])
            tally.others(got[2][keep], want[2][keep])
            checks[name] = tally.numbers()
            print(f"kept unit {name}: {int((~keep).sum())} lane-steps "
                  "explained by their upstream sum's last bits",
                  file=sys.stderr)
            del want, keep
            checks[name]["basin_q_rel"] = rm.basin_gap(
                ref.basin_sums(got[0]),
                self._free_da_sums(ref, q0, d0, e0, ql, st0, obs))
            del got
            if control:
                got_st = rm.handoff(got_st, self.hour_s)
            checks[name]["da_state_gap"] = rm.state_gap(
                got_st, rm.handoff(want_st, self.hour_s))
            if not control:
                st, last = out["state"], fvd[-1]
                checks[name]["state_gap"] = max(
                    float((st.q - last[:, 0]).abs().max()),
                    float((st.depth - last[:, 2]).abs().max()),
                    float((st.res_elev - last[self.res_rows, 2]).abs().max()))
        return checks

    def _free_da_sums(self, ref, q0, d0, e0, ql, st, obs) -> torch.Tensor:
        """[steps, basins] basin sums of the flows of ``ref`` run free with
        DA for one hour from the hour's start."""
        sums = []
        ref.run_da(q0, d0, e0, ql, self.steps, self.dt, st, obs,
                   on_step=lambda t, q, v, d: sums.append(ref.basin_sums(q)))
        return torch.stack(sums)

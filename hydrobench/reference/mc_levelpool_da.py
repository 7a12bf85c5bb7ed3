"""Plain reference of short-timestep Muskingum-Cunge routing with
level-pool lakes, gage nudging and typed reservoir data assimilation: the
reference of ``nwm_conus_ana``.

It builds on ``mc_levelpool`` (the MC secant and the level pool on every
segment and lake, upstream lists and basins from ids) and adds, at each
step after the level pool:

* on the lakes typed 2 or 3 (USGS or USACE persistence), T-Route's hybrid
  persistence DA, and on those typed 4 or 5 (CONUS or Alaska RFC), its RFC
  forecast DA, each transcribed from the scalar oracles of the test suite
  (``hybrid_da_ref`` and ``rfc_da_ref``, which follow
  ``reservoir_hybrid_da.py:55`` and ``reservoir_RFC_da.py:196``) into
  masks over the lakes of that type;
* on the gage segments, T-Route's ``simple_da`` nudging
  (``simple_da.pyx:21-89``): a gage step with an observation takes it and
  remembers it; one without takes the model's flow plus the gap to the
  last observation, decayed by exp(-|minutes since it| / decay).

Departures from those sources, none of which the benchmark's traffic
reaches but the first:

* a gage is nudged on its own segment once every segment has stepped
  (T-Route nudges the last segment of a reach whose tail is a gage; here
  every segment is a reach);
* the persistence search takes the observation times ascending and
  distinct (the last time at or before the update time is the nearest);
* an RFC index past the series reads its last value;
* no Great Lakes DA (type 6): such a lake raises.

Clocks count seconds from the start of the hour being routed; the hand-off
between hours (``handoff``) subtracts the hour's seconds from each of
them.  The state is kept in the reference's own order (gages as given,
lakes ascending by row).  Nothing of the program is imported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hydrobench.reference import mc_levelpool
from hydrobench.reference.mc_levelpool import (  # noqa: F401 (the judge's)
    FLOOR, Tally, basin_gap)

PERSISTENCE_LIMIT = 11
SEARCH_EVERY_S = 3600.0
CYCLE_S = 86400.0


class DAState(NamedTuple):
    """What DA carries from one step to the next: gages [G], lakes [L]."""

    lastobs_val: torch.Tensor     # NaN: no observation yet
    lastobs_time: torch.Tensor    # s
    persisted: torch.Tensor       # persistence: outflow held (NaN: none)
    update_time: torch.Tensor     # persistence: next search (s)
    p_index: torch.Tensor         # persistence: cycles held
    p_update_time: torch.Tensor   # persistence: next cycle (s)
    rfc_idx: torch.Tensor         # RFC: index into the series (int64)
    rfc_update_time: torch.Tensor  # RFC: next advance (s)


class HourObs(NamedTuple):
    """What one hour's observations and forecasts hold."""

    gage: torch.Tensor       # [steps + 1, G], row t at step t, NaN missing
    lake: torch.Tensor       # [L, n_obs] persistence gages, NaN missing
    lake_time: torch.Tensor  # [n_obs] s, ascending
    rfc: torch.Tensor        # [L, n_counts] forecast series


def _nearest_before(times: torch.Tensor, at: torch.Tensor) -> torch.Tensor:
    """Per lane, the index of the last of ascending ``times`` at or before
    ``at`` (0 where none is, as the oracle's argmin gives)."""
    return ((times[None, :] <= at[:, None]).sum(1) - 1).clamp_min(0)


def _last_valid(obs: torch.Tensor) -> torch.Tensor:
    """[lanes, n]: for each column, the last column at or before it whose
    value is not NaN (-1 where none is)."""
    col = torch.arange(obs.shape[1], device=obs.device)
    mark = torch.where(torch.isnan(obs), -1, col[None, :])
    return torch.cummax(mark, dim=1).values


def hybrid(obs, obs_time, now: float, prev, ut, p_idx, p_ut, lp_out,
           inflow, dt: float, area, max_elev, orifice_elev, elev,
           lookback_s: float):
    """Hybrid persistence DA on [H] lanes: (outflow, elevation, persisted,
    update time, cycles held, next cycle)."""
    search = now >= ut
    pick = _last_valid(obs).gather(1, _nearest_before(obs_time, ut)[:, None])
    pick = pick[:, 0]
    found = pick >= 0
    at = pick.clamp_min(0)
    val = obs.gather(1, at[:, None])[:, 0]
    fresh = search & found & ((ut - obs_time[at]) <= lookback_s)
    quiet = ~search
    cycle = now >= p_ut

    new_ut = torch.where(search & found, ut + SEARCH_EVERY_S, ut)
    persisted = torch.where(fresh, val, prev)
    # a cycle boundary without a fresh observation counts one more cycle
    bump = ~fresh & cycle
    new_idx = torch.where(bump, p_idx + 1, p_idx)
    new_put = torch.where(bump, p_ut + CYCLE_S, p_ut)
    new_idx = torch.where(fresh, torch.ones_like(p_idx), new_idx)
    new_put = torch.where(fresh, p_ut + CYCLE_S, new_put)
    # between searches, past the limit, persistence ends
    over = quiet & cycle & (p_idx > PERSISTENCE_LIMIT)
    persisted = torch.where(over, lp_out, persisted)
    new_idx = torch.where(over, torch.zeros_like(p_idx), new_idx)
    none = torch.isnan(persisted)
    outflow = torch.where(none, lp_out, persisted)
    new_idx = torch.where(none, torch.zeros_like(p_idx), new_idx)

    # the projected storage bounds the outflow
    sq = area * 1e6
    projected = (elev - orifice_elev) * sq + (inflow - outflow) * dt
    out = outflow.clamp_min(0.0)
    out = torch.where(projected <= 0.0, inflow, out).clamp_min(0.0)
    out = torch.where((projected > (max_elev - orifice_elev) * sq)
                      & (out < lp_out), lp_out, out)
    new_elev = elev + ((inflow - out) * dt) / sq
    return out, new_elev, persisted, new_ut, new_idx, new_put


def rfc(series, counts, idx, ut, step, persist_s, rtype, now: float,
        inflow, elev, lp_out, lp_elev, area, max_elev, dt: float):
    """RFC forecast DA on [R] lanes: (outflow, elevation, index, next
    advance)."""
    live = torch.full(idx.shape, now <= persist_s, device=idx.device)
    adv = live & (now >= ut) & (idx < counts)
    new_ut = torch.where(adv, ut + step, ut)
    new_idx = torch.where(adv, idx + 1, idx)
    j = new_idx.clamp(0, series.shape[1] - 1)
    val = series.gather(1, j[:, None])[:, 0]
    conus = rtype == 4
    fallback = torch.where(conus, lp_out, inflow)
    out = torch.where(conus, val, inflow + val)
    new_elev = torch.minimum(
        (elev + ((inflow - out) / (area * 1e6)) * dt).clamp_min(0.0),
        max_elev)
    # a negative release walks back to the last series value at or above
    # zero among indices 1 .. index - 1; with none, the fallback
    col = torch.arange(series.shape[1], device=series.device)
    elig = (col[None, :] >= 1) & (col[None, :] < j[:, None]) \
        & (series >= 0.0)
    back = torch.where(elig, col[None, :], -1).amax(1)
    neg = out < 0.0
    out_back = series.gather(1, back.clamp_min(0)[:, None])[:, 0]
    dead = neg & (back < 0)
    out = torch.where(neg & (back >= 0), out_back, out)
    out = torch.where(dead, fallback, out)
    new_elev = torch.where(dead, lp_elev, new_elev)
    out = torch.where(live, out, fallback)
    new_elev = torch.where(live, new_elev, lp_elev)
    return out, new_elev, new_idx, new_ut


class Network(mc_levelpool.Network):
    """``mc_levelpool.Network`` with gages and typed lakes.

    ``gages``: the rows of the gage segments (their order is the gage
    order of observations and state); ``lake_type``: [n_lakes] 1 level
    pool, 2/3 persistence, 4/5 RFC; ``rfc_counts``: [n_lakes] values each
    RFC series holds; ``rfc_step_s``, ``rfc_persist_s``: an RFC series'
    time step and how long after an hour's start it is followed."""

    def __init__(self, ids, down, chan: dict, lakes, lake_params, gages,
                 lake_type, rfc_counts, *, decay_min: float,
                 lookback_hours: float, rfc_step_s: float,
                 rfc_persist_s: float, device, dtype=torch.float32):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(ids, down, chan, lakes, lake_params, device=device,
                         dtype=dtype)
        lake_type = np.asarray(lake_type, np.int64)
        if np.any(lake_type == 6) or np.any((lake_type < 1)
                                             | (lake_type > 6)):
            raise ValueError("the reference has no Great Lakes DA")

        def rows(mask):
            return torch.as_tensor(np.flatnonzero(mask), device=device)
        self.gages = torch.as_tensor(np.asarray(gages, np.int64),
                                     device=device)
        self.hyb = rows((lake_type == 2) | (lake_type == 3))
        self.rfc_lanes = rows((lake_type == 4) | (lake_type == 5))
        self.rfc_type = torch.as_tensor(lake_type, device=device)[
            self.rfc_lanes]
        self.rfc_counts = torch.as_tensor(np.asarray(rfc_counts, np.int64),
                                          device=device)[self.rfc_lanes]
        self.decay_min = float(decay_min)
        self.lookback_s = float(lookback_hours) * 3600.0
        self.rfc_step_s = float(rfc_step_s)
        self.rfc_persist_s = float(rfc_persist_s)

    def state(self, lastobs_val, lastobs_time, persisted, update_time,
              p_index, p_update_time, rfc_idx, rfc_update_time) -> DAState:
        """A ``DAState`` of the given values in this network's dtype (the
        RFC index as int64)."""
        f = [torch.as_tensor(x, device=self.device).to(self.dtype)
             for x in (lastobs_val, lastobs_time, persisted, update_time,
                       p_index, p_update_time)]
        return DAState(*f, torch.as_tensor(rfc_idx, device=self.device)
                       .to(torch.int64),
                       torch.as_tensor(rfc_update_time, device=self.device)
                       .to(self.dtype))

    def hour_obs(self, gage, lake, lake_time, rfc_series) -> HourObs:
        return HourObs(*[torch.as_tensor(x, device=self.device).to(self.dtype)
                         for x in (gage, lake, lake_time, rfc_series)])

    def _lake_da(self, st: DAState, obs: HourObs, now: float, elev,
                 inflow, lp_out, lp_elev, dt: float):
        """The typed lakes' DA at time ``now`` on [L] lanes: (outflow,
        elevation, DA state)."""
        out, new_elev = lp_out.clone(), lp_elev.clone()
        p = self.lake_params
        h = self.hyb
        if h.numel():
            o, e, pers, ut, pi, put = hybrid(
                obs.lake[h], obs.lake_time, now, st.persisted[h],
                st.update_time[h], st.p_index[h], st.p_update_time[h],
                lp_out[h], inflow[h], dt, p[h, 0], p[h, 1], p[h, 4],
                elev[h], self.lookback_s)
            out[h], new_elev[h] = o, e
            st = st._replace(
                persisted=st.persisted.index_put((h,), pers),
                update_time=st.update_time.index_put((h,), ut),
                p_index=st.p_index.index_put((h,), pi),
                p_update_time=st.p_update_time.index_put((h,), put))
        r = self.rfc_lanes
        if r.numel():
            o, e, ri, rut = rfc(
                obs.rfc[r], self.rfc_counts, st.rfc_idx[r],
                st.rfc_update_time[r], self.rfc_step_s, self.rfc_persist_s,
                self.rfc_type, now, inflow[r], elev[r], lp_out[r],
                lp_elev[r], p[r, 0], p[r, 1], dt)
            out[r], new_elev[r] = o, e
            st = st._replace(
                rfc_idx=st.rfc_idx.index_put((r,), ri),
                rfc_update_time=st.rfc_update_time.index_put((r,), rut))
        return out, new_elev, st

    def _nudge(self, model, st: DAState, obs: HourObs, t: int, now: float):
        """``simple_da`` at step ``t`` on the [G] gage lanes' model flows:
        (flows, DA state)."""
        obs_t = (obs.gage[t] if t < obs.gage.shape[0] else
                 torch.full(model.shape, float("nan"), dtype=model.dtype,
                            device=model.device))
        have = ~torch.isnan(obs_t)
        weight = torch.exp(torch.abs((now - st.lastobs_time) / 60.0)
                           / -self.decay_min)
        decayed = model + (st.lastobs_val - model) * weight
        q = torch.where(have, obs_t,
                        torch.where(torch.isnan(st.lastobs_val), model,
                                    decayed))
        return q, st._replace(
            lastobs_val=torch.where(have, obs_t, st.lastobs_val),
            lastobs_time=torch.where(have, now, st.lastobs_time))

    def step_da(self, q, d, elev, ql, dt: float, st: DAState, obs: HourObs,
                t: int):
        """Step ``t`` (1 based) of an hour from [N] states: (q, v, d, elev,
        evals per channel lane, DA state after it)."""
        now = float(t * dt)
        q_new, v_new, d_new, lp_elev, evals = self.step(q, d, elev, ql, dt)
        out, new_elev, st = self._lake_da(
            st, obs, now, elev, self.upstream_sum(q)[self.lakes],
            q_new[self.lakes], lp_elev, dt)
        q_new[self.lakes] = out
        d_new[self.lakes] = new_elev
        if self.gages.numel():
            q_new[self.gages], st = self._nudge(q_new[self.gages], st, obs,
                                                t, now)
        return q_new, v_new, d_new, new_elev, evals, st

    def chain(self, qs, ds, es, ql, dt: float, st: DAState, obs: HourObs):
        """Each step t of an hour from the states ``qs[t - 1]``, ``ds[t -
        1]``, ``es[t - 1]`` given (an hour's start for t = 1, then the
        judged program's own), with the DA state carried from step to step
        by this reference alone: ([steps, N] q, v, d, the DA state after
        the last step).  Step t's values are ``step_da``'s from the same
        state; the channel and the level pool step all the hour's states
        side by side, then the DA state walks the steps (no DA state
        depends on a channel flow but through the lakes' level pool)."""
        steps = qs.shape[0]
        qs, ds, es = (x.to(self.dtype) for x in (qs, ds, es))
        q_new, v_new, d_new, lp_elev, _ = self.step(
            qs, ds, es, ql.to(self.dtype).expand(steps, -1), dt)
        lp_out = q_new[:, self.lakes]
        inflow = self.upstream_sum(qs)[:, self.lakes]
        model = q_new[:, self.gages]
        for t in range(steps):
            now = float((t + 1) * dt)
            out, elev, st = self._lake_da(st, obs, now, es[t], inflow[t],
                                          lp_out[t], lp_elev[t], dt)
            q_new[t, self.lakes] = out
            d_new[t, self.lakes] = elev
            if self.gages.numel():
                q_new[t, self.gages], st = self._nudge(model[t], st, obs,
                                                       t + 1, now)
        return q_new, v_new, d_new, st

    def run_da(self, q, d, elev, ql, steps: int, dt: float, st: DAState,
               obs: HourObs, on_step=None):
        """``steps`` steps of one hour from (q, d, elev) and DA state ``st``
        on their own; ``on_step(t, q, v, d)`` sees each.  Returns the final
        (q, v, d, elev, DA state)."""
        q, d, elev, ql = (x.to(self.dtype) for x in (q, d, elev, ql))
        v = torch.zeros_like(q)
        for t in range(1, steps + 1):
            q, v, d, elev, _, st = self.step_da(q, d, elev, ql, dt, st, obs,
                                                t)
            if on_step is not None:
                on_step(t, q, v, d)
        return q, v, d, elev, st


def handoff(st: DAState, seconds: float) -> DAState:
    """The DA state as the next hour starts: every clock less the hour's
    seconds."""
    return st._replace(
        lastobs_time=st.lastobs_time - seconds,
        update_time=st.update_time - seconds,
        p_update_time=st.p_update_time - seconds,
        rfc_update_time=st.rfc_update_time - seconds)


def state_gap(got: DAState, want: DAState) -> float:
    """The largest relative gap, against max(|want|, ``FLOOR``), between
    two DA states, field by field; NaN against NaN is no gap, NaN against a
    number an infinite one."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.to(torch.float64), w.to(torch.float64)
        if g.shape != w.shape:
            return float("inf")
        both = torch.isnan(g) & torch.isnan(w)
        rel = (g - w).abs() / w.abs().clamp_min(FLOOR)
        rel = torch.where(both, 0.0, rel.nan_to_num(nan=float("inf")))
        if rel.numel():
            worst = max(worst, float(rel.max()))
    return worst

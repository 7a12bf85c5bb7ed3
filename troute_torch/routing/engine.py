"""Muskingum-Cunge routing engine in PyTorch.

Port of ``route`` and ``route_stepped`` of ``troute_tpu/routing/engine.py``.
Each timestep runs in one of three forms:

* short timestep (``assume_short_ts=True``, the NWM production mode):
  every node's state at timestep t depends only on the state at t-1, so
  the whole network advances in one vector step per timestep
  (``_one_short_step``): the upstream flow sums, the MC secant solve
  through the CUDA kernel wrapper (its plain version for CPU tensors),
  level-pool reservoirs with optional typed reservoir DA, gage nudging;
* strict fixed point (``assume_short_ts=False, strict_iterative=True``):
  the current-step upstream flow couples nodes within a timestep, and each
  timestep iterates that step as Jacobi sweeps until the iterate stops
  moving.  ``route_stepped`` polls chunks of sweeps from the host (with
  the linear accelerator, the block-skip kernel or Gauss-Seidel column
  sweeps as options); ``route`` runs the JAX ``route()``'s while loop,
  one poll per sweep, then one commit sweep;
* strict level scan (``assume_short_ts=False, strict_iterative=False``,
  ``route`` only): the reference's own within-step order.  The rows of
  one wavefront level (``NetworkArrays.level_nodes``) are solved together
  once every lower level is final; reservoirs and gages of a level are
  dispatched and nudged before the next level reads them.

Semantics follow ``mc_reach.pyx``: qup = sum of upstream flows at t-1, quc
the same sum at t (at t-1 in short mode); lateral inflow column (t-1) //
qts_subdivisions; reservoirs receive the quc sum as inflow, with previous
inflow = current inflow (``bind_lp.f90:71-72``); nudging follows
``simple_da.pyx:21-89``.

Every tensor of one call lies on one device in one float dtype, which the
caller picks; functions that build tensors take ``device`` and ``dtype``
explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from troute_torch.network.topology import NODE_RESERVOIR
from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.ops.levelpool_cuda import (levelpool_da_rows_cuda,
                                             levelpool_da_step_cuda,
                                             levelpool_rows_cuda,
                                             levelpool_step_cuda)
from troute_torch.ops.muskingum_cuda import (block_active_lanes,
                                             muskingum_cunge_cuda)
from troute_torch.ops.reservoir_da import (GreatLakesDAState, HybridDAState,
                                           RfcDAState)
from troute_torch.routing.upstream_plan import (UpstreamOp, build_upstream_plan,
                                                remainder_add)
from troute_torch.tracing import count, device_allocs, span


class ChannelParams(NamedTuple):
    """Columnar per-node MC channel geometry [N]; values at reservoir rows
    are ignored."""

    dx: torch.Tensor
    bw: torch.Tensor
    tw: torch.Tensor
    twcc: torch.Tensor
    n: torch.Tensor
    ncc: torch.Tensor
    cs: torch.Tensor
    s0: torch.Tensor

    @classmethod
    def from_arrays(cls, *, device, dtype, **kw) -> "ChannelParams":
        return cls(**{k: torch.as_tensor(np.asarray(v), dtype=dtype,
                                         device=device)
                      for k, v in kw.items()})


class NetworkArrays(NamedTuple):
    """Topology index tensors on the routing device."""

    upstream: torch.Tensor        # int64 [N, K], -1 padded
    is_reservoir: torch.Tensor    # bool [N]
    res_rows: torch.Tensor        # int64 [n_res] node rows of reservoirs
    uplan: UpstreamOp | None = None   # banded plan; None: gather form
    # int64 [n_rows, W] level-scan schedule, -1 padded (None: no level scan)
    level_nodes: torch.Tensor | None = None


class GageDA(NamedTuple):
    """Streamflow-nudging data assimilation inputs."""

    rows: torch.Tensor          # int64 [n_gages] node rows with gages
    obs: torch.Tensor           # [nts+1, n_gages], NaN where missing;
                                # row t aligns with timestep t
    lastobs_val: torch.Tensor   # [n_gages] last obs before t0 (NaN if none)
    lastobs_time: torch.Tensor  # [n_gages] obs time in s rel. to t0 (<= 0)
    decay_coeff: float          # minutes


class ReservoirDAData(NamedTuple):
    """Pre-staged reservoir DA inputs, one lane per reservoir slot.

    ``wbody_type``: 1 levelpool, 2 USGS and 3 USACE hybrid persistence,
    4 CONUS RFC forecast, 5 Alaska glacier RFC, 6 Great Lake.
    """

    wbody_type: torch.Tensor          # int32 [n_res]
    hybrid_obs: torch.Tensor          # [n_res, n_hobs] (NaN = missing)
    hybrid_obs_time: torch.Tensor     # [n_hobs] seconds since t0
    hybrid_state0: HybridDAState
    rfc_series: torch.Tensor          # [n_res, n_counts]
    rfc_counts: torch.Tensor          # int32 [n_res]
    rfc_use: torch.Tensor             # bool [n_res]
    rfc_timestep: torch.Tensor        # [n_res] seconds
    rfc_persist_seconds: torch.Tensor  # [n_res]
    rfc_state0: RfcDAState
    gl_obs: torch.Tensor              # [n_res, n_gobs]
    gl_obs_time: torch.Tensor         # [n_res, n_gobs]
    gl_climatology: torch.Tensor      # [n_res, 12]
    gl_state0: GreatLakesDAState
    # int32 [nts+1] calendar month-1, on the host (the drivers read it
    # there once a call; a device tensor costs a copy back each call)
    month_idx: torch.Tensor
    obs_lookback_hours: float = 48.0

    @classmethod
    def inactive(cls, n_res: int, nts: int, *, device,
                 dtype) -> "ReservoirDAData":
        """All-levelpool placeholder (no DA)."""
        n = max(n_res, 1)

        def f(*s):
            return torch.zeros(s, dtype=dtype, device=device)

        def nan(*s):
            return torch.full(s, float("nan"), dtype=dtype, device=device)

        def i32(*s):
            return torch.zeros(s, dtype=torch.int32, device=device)

        return cls(
            wbody_type=torch.ones(n, dtype=torch.int32, device=device),
            hybrid_obs=nan(n, 1), hybrid_obs_time=f(1),
            hybrid_state0=HybridDAState(
                persisted_outflow=nan(n), update_time=f(n),
                persistence_index=f(n), persistence_update_time=f(n)),
            rfc_series=f(n, 1), rfc_counts=i32(n),
            rfc_use=torch.zeros(n, dtype=torch.bool, device=device),
            rfc_timestep=torch.ones(n, dtype=dtype, device=device),
            rfc_persist_seconds=f(n),
            rfc_state0=RfcDAState(timeseries_idx=i32(n), update_time=f(n)),
            gl_obs=nan(n, 1), gl_obs_time=f(n, 1), gl_climatology=f(n, 12),
            gl_state0=GreatLakesDAState(
                assimilated_outflow=nan(n), assimilated_time=f(n),
                update_time=f(n)),
            month_idx=torch.zeros(nts + 1, dtype=torch.int32))


class RoutingConfig(NamedTuple):
    """The JAX engine's configuration, field for field, so a config
    carries across.  ``route_stepped`` reads every field but ``kernel``:
    the stepped engine always takes the MC kernels.  The strict fields
    mean what they mean in the JAX package (its ``RoutingConfig``
    comments); ``strict_accel`` "auto" is on and ``strict_block_skip``
    "auto" is off, and both also take the strings a YAML file gives
    ("true", "1", "off", ...)."""

    dt: float
    nts: int
    qts_subdivisions: int = 1
    assume_short_ts: bool = False
    return_courant: bool = False
    kernel: str = "xla"
    strict_iterative: bool = False
    strict_tol: float = 1e-9
    strict_max_sweeps: int = 64
    strict_sweep_chunk: int = 16
    strict_gs: bool = False
    strict_gs_cols: int = 16
    strict_accel: bool | str = "auto"
    strict_accel_lin: int = 8
    strict_accel_chunk: int = 8
    strict_block_skip: bool | str = "auto"


class RoutingState(NamedTuple):
    """Carry between timesteps (and between windows)."""

    q: torch.Tensor             # [N] flow
    depth: torch.Tensor         # [N] depth (MC) / water elevation (reservoir)
    res_elev: torch.Tensor      # [n_res] reservoir water elevation
    lastobs_val: torch.Tensor   # [n_gages]
    lastobs_time: torch.Tensor  # [n_gages]
    hybrid: HybridDAState | None = None
    rfc: RfcDAState | None = None
    gl: GreatLakesDAState | None = None


def network_arrays_from_topology(topo, *, device, need_levels: bool = False,
                                 level_chunk_width: int | None = None
                                 ) -> NetworkArrays:
    """Index tensors of a ``RoutingTopology`` on ``device``, with the
    banded upstream-sum plan at the network's length when the row order
    allows one (``routing/upstream_plan.py``); else the gather form.
    ``need_levels`` adds the level scan's schedule: one row per level, or
    rows of at most ``level_chunk_width`` nodes when it is given."""
    levels = None
    if need_levels:
        levels = torch.as_tensor(
            topo.level_nodes if level_chunk_width is None
            else topo.level_chunks(level_chunk_width),
            dtype=torch.int64, device=device)
    upstream = np.asarray(topo.upstream)
    uop = None
    plan = build_upstream_plan(upstream, topo.n_nodes)
    if plan is not None:
        upstream = plan.upstream_sorted
        uop = UpstreamOp.from_plan(plan, device=device)
    return NetworkArrays(
        upstream=torch.as_tensor(upstream, dtype=torch.int64, device=device),
        is_reservoir=torch.as_tensor(topo.node_type == NODE_RESERVOIR,
                                     device=device),
        res_rows=torch.as_tensor(topo.reservoir_rows, dtype=torch.int64,
                                 device=device),
        uplan=uop, level_nodes=levels)


def _upstream_sum(q: torch.Tensor, upstream: torch.Tensor) -> torch.Tensor:
    """Sum of q over each row's (padded) upstream list, one per row of
    ``upstream``, adding the columns left to right (the plan's
    accumulation order)."""
    vals = torch.where(upstream >= 0, q[torch.clamp_min(upstream, 0)], 0.0)
    up = q.new_zeros(upstream.shape[0])
    for k in range(vals.shape[1]):
        up = up + vals[:, k]
    return up


def _upstream_sum_stepped(q, upstream, uplan):
    """Per-node upstream flow sums: the banded plan when the network has
    one, the gather form otherwise."""
    if uplan is not None:
        return uplan(q)
    return _upstream_sum(q, upstream)


def _nudge(model, t_seconds: float, decay_coeff: float, lastobs_val,
           lastobs_time, obs_t):
    """``simple_da`` on gage lanes (reference ``simple_da.pyx:21-89``):
    (nudged flow, nudge, new last obs value, new last obs time)."""
    have_obs = ~torch.isnan(obs_t)
    minutes = (t_seconds - lastobs_time) / 60.0
    weight = torch.exp(torch.abs(minutes) / -decay_coeff)
    shift = (lastobs_val - model) * weight
    no_memory = torch.isnan(obs_t) & torch.isnan(lastobs_val)

    replaced = torch.where(have_obs, obs_t,
                           torch.where(no_memory, model, model + shift))
    nudge = torch.where(have_obs, obs_t - model,
                        torch.where(no_memory, 0.0, shift))
    new_val = torch.where(have_obs, obs_t, lastobs_val)
    new_time = torch.where(have_obs, t_seconds, lastobs_time)
    return replaced, nudge, new_val, new_time


def _apply_nudging(q, rows, t_seconds: float, decay_coeff: float,
                   lastobs_val, lastobs_time, obs_t):
    """Vectorized ``simple_da`` on the gage lanes at ``rows`` of ``q``
    (``obs_t`` the step's observations, NaN where missing), inside the
    span ``engine.nudge``; the counter ``engine.nudge_lanes`` adds the
    gage lanes.  Returns (q, nudge, new last obs value, new last obs
    time)."""
    with span("engine.nudge"):
        count("engine.nudge_lanes", rows.shape[0])
        replaced, nudge, new_val, new_time = _nudge(
            q[rows], t_seconds, decay_coeff, lastobs_val, lastobs_time,
            obs_t)
        q = q.index_put((rows,), replaced)
    return q, nudge, new_val, new_time


def _resolve_flag(v, auto: bool) -> bool:
    """A strict option: "auto" gives ``auto``; strings as a YAML file
    writes them ("true", "1", "off", ...) and other values by their truth
    (so ``1`` and ``"true"`` turn an option on)."""
    if isinstance(v, str):
        word = v.strip().lower()
        if word == "auto":
            return auto
        if word in ("true", "1", "yes", "on"):
            return True
        if word in ("false", "0", "no", "off"):
            return False
        raise ValueError(f"unrecognised flag value {v!r}")
    return bool(v)


def _accel_enabled(cfg: "RoutingConfig", stepped: bool) -> bool:
    """Resolve ``strict_accel``: "auto" is ON for the host-stepped driver
    and OFF for an in-scan engine, as in the JAX package."""
    return _resolve_flag(cfg.strict_accel, stepped)


def mc_linear_gain(ck, x, dx, dt: float, q_new=None, g_prev=None, quc=None,
                   quc_prev=None):
    """Per-lane linear gain dq_dc/dq_uc for the strict accelerators.

    The analytic fixed-depth partial C2 = (dt/2 - Km X)/(Km(1-X) + dt/2),
    Km = max(dt, dx/ck); with the last two sweeps' outputs and drives
    given, the measured response (q_new - g_prev)/(quc - quc_prev) replaces
    it where the drive moved by more than 16 eps (|quc| + 1) and the ratio
    is a finite contraction.
    """
    fi = torch.finfo(ck.dtype)
    km = torch.where(ck > 0.0,
                     torch.clamp_min(dx / torch.clamp_min(ck, fi.tiny), dt),
                     dt)
    den = km * (1.0 - x) + dt / 2.0
    gain = (dt / 2.0 - km * x) / torch.where(den != 0.0, den, 1.0)
    if q_new is not None:
        du = quc - quc_prev
        resolvable = torch.abs(du) > 16.0 * fi.eps * (torch.abs(quc) + 1.0)
        g_emp = (q_new - g_prev) / torch.where(resolvable, du, 1.0)
        ok = resolvable & torch.isfinite(g_emp) & (torch.abs(g_emp) < 1.0)
        gain = torch.where(ok, g_emp, gain)
    return gain


def accel_gain(ck, x, dx, dt: float, q_new, g_prev, quc, quc_prev,
               emp_ok: bool):
    """Gain for one accelerator insertion: the measured response when
    ``emp_ok`` (``g_prev``/``quc_prev`` are the previous sweep's pair),
    else the analytic C2 alone (at the first sweep the drive moved against
    the previous timestep's sums, not a sweep).  Callers zero the gain on
    reservoir and gage lanes."""
    if not emp_ok or g_prev is None:
        return mc_linear_gain(ck, x, dx, dt)
    return mc_linear_gain(ck, x, dx, dt, q_new=q_new, g_prev=g_prev,
                          quc=quc, quc_prev=quc_prev)


def apply_linear_accel(q_new, dq, gain, sum_fn, n_terms: int):
    """Linearized-propagation jump q* ~ q_new + sum_{j=1..n} (g .* U)^j dq,
    with U applied by ``sum_fn`` (the upstream sum), clamped at zero like
    the sweeps' own output."""
    acc, lin = q_new, dq
    for _ in range(int(n_terms)):
        lin = gain * sum_fn(lin)
        acc = acc + lin
    return torch.clamp_min(acc, 0.0)


def _reservoirs(res_params: LevelpoolParams, res_da, res_elev, inflow,
                da_states, t_seconds: float, month_i, dt: float):
    """Level pool, then the typed reservoir DA when ``res_da`` is given
    (``mc_reach.pyx:507-717``), on reservoir lanes that see ``inflow``:
    (outflow, elevation, the depth column's value, DA states).  On the card
    one launch of kernel L1's lane form; with DA, of its DA form, inside
    the span ``engine.reservoir_da``."""
    if res_da is None:
        lp_out, lp_elev = levelpool_step_cuda(res_elev, inflow, inflow, None,
                                              dt, res_params)
        return lp_out, lp_elev, lp_elev, da_states
    with span("engine.reservoir_da"):
        count("engine.reservoir_da_lanes", res_elev.shape[0])
        return levelpool_da_step_cuda(res_elev, inflow, dt, res_params,
                                      res_da, da_states, t_seconds, month_i)


def _one_short_step(q, depth, res_elev, lo_val, lo_time, ql_t, obs_t,
                    t_seconds: float, upstream, chan: ChannelParams,
                    res_params: LevelpoolParams, is_res, res_rows,
                    gage_rows, decay_coeff: float, dt: float, res_da=None,
                    da_states=None, month_i: int | None = None,
                    return_courant: bool = False, uplan=None, quc=None,
                    active_rows=None, prev=None, want_raw: bool = False):
    """One routing step: upstream sums, MC kernel, reservoirs (with typed
    DA when ``res_da`` is given), nudging.

    ``quc`` (current-step upstream sums) defaults to the previous-step
    sums, the short-timestep approximation; the strict sweeps pass their
    iterate's sums, and reservoirs then see current-step inflows.
    ``active_rows``/``prev`` select the block-skip kernel (see
    ``muskingum_cunge_cuda``).

    Returns (q, v, depth, res_elev, lo_val, lo_time, nudge, da_states,
    courant), plus the raw ``MCOutput`` with ``want_raw``; courant is
    [N, 3] (cn, ck, X) or None.
    """
    with span("engine.upstream_sum"):
        up_prev = _upstream_sum_stepped(q, upstream, uplan)
    if quc is None:
        quc = up_prev

    with span("engine.mc"):
        out = muskingum_cunge_cuda(
            up_prev, quc, q, ql_t, chan.dx, chan.bw, chan.tw, chan.twcc,
            chan.n, chan.ncc, chan.cs, chan.s0, depth, dt,
            with_diagnostics=return_courant, active_rows=active_rows,
            prev=prev)
    courant = (torch.stack([out.cn, out.ck, out.X], dim=-1)
               if return_courant else None)

    q_new = torch.where(is_res, q, out.qdc)
    v_new = torch.where(is_res, 0.0, out.velc)
    d_new = torch.where(is_res, depth, out.depthc)

    if res_rows.shape[0]:
        with span("engine.reservoirs"):
            # one launch on the card: the lakes' inflow gather, the level
            # pool, the typed DA when given, and the scatter into q_new and
            # d_new (fresh tensors of the torch.where above)
            if res_da is None:
                res_elev = levelpool_rows_cuda(res_elev, quc, res_rows, dt,
                                               res_params,
                                               into=(q_new, d_new))
            else:
                with span("engine.reservoir_da"):
                    count("engine.reservoir_da_lanes", res_rows.shape[0])
                    res_elev, da_states = levelpool_da_rows_cuda(
                        res_elev, quc, res_rows, dt, res_params, res_da,
                        da_states, t_seconds, month_i, into=(q_new, d_new))

    nudge = q.new_zeros(gage_rows.shape[0])
    if gage_rows.shape[0]:
        q_new, nudge, lo_val, lo_time = _apply_nudging(
            q_new, gage_rows, t_seconds, decay_coeff, lo_val, lo_time, obs_t)

    res = (q_new, v_new, d_new, res_elev, lo_val, lo_time, nudge,
           da_states, courant)
    return res + (out,) if want_raw else res


def _strict_sweeps(q_est, q, depth, res_elev, lo_val, lo_time, ql_t, obs_t,
                   t_seconds: float, upstream, chan: ChannelParams,
                   res_params: LevelpoolParams, is_res, res_rows, gage_rows,
                   decay_coeff: float, dt: float, n_sweeps: int, res_da=None,
                   da_states=None, month_i: int | None = None,
                   return_courant: bool = False, uplan=None,
                   accel_lin: int = 0, gain0=None, skip_tol=None):
    """``n_sweeps`` Jacobi fixed-point sweeps of one strict timestep
    (``troute_tpu/routing/engine.py:_strict_sweep_kernel``).

    The previous-step state (q, depth, reservoir and DA state) stays fixed;
    each sweep reruns the step with ``quc`` = the upstream sums of the
    iterate ``q_est``, so reservoir inflows and nudging see current-step
    sums.  With ``accel_lin > 0`` the iterate jumps by ``accel_lin``
    linear terms between sweeps, never after the last one, with the gain
    zeroed on reservoir and gage lanes; ``gain0`` (the previous step's last
    gain) seeds the first insertion.  With ``skip_tol`` the sweeps
    ``1 <= k < n_sweeps - 1`` run the block-skip kernel on the lanes whose
    drive moved more than ``skip_tol`` since their block's last solve
    (``quc_ref``); the last sweep always solves every lane.

    With both, a lane the skip kernel passed through holds its output
    while its drive moved, so the measured gain pairs each output with the
    drive it was solved at (``quc_ref``) and a lane that was not solved
    keeps its last gain.  The JAX kernel pairs the held output with the
    new drive, measures a zero response there and carries it into the
    next step (``engine.py:1093``, ``:1114-1115``), which slows the
    accelerated iteration; the fixed point is the same.

    Returns the last sweep's (q_est, v, depth, res_elev, lo_val, lo_time,
    nudge, da_states, courant or None), then ``delta`` = max |dq| of the
    last sweep and ``qmax`` = max |q_est|, both 0-d tensors left on the
    device, then the last gain when ``accel_lin > 0``.
    """
    compute_gain = accel_lin > 0
    quc_prev = g_prev = gain = quc_ref = raw = None

    def usum(v):
        return _upstream_sum_stepped(v, upstream, uplan)

    for k in range(n_sweeps):
        quc = usum(q_est)
        active_rows = None
        if skip_tol is not None and 1 <= k < n_sweeps - 1:
            active_rows = torch.abs(quc - quc_ref) > skip_tol
        gain_sweep = compute_gain and k < n_sweeps - 1
        (q_new, v, d, res_elev_c, lo_val_c, lo_time_c, nudge, da_states_c,
         courant, raw) = _one_short_step(
            q, depth, res_elev, lo_val, lo_time, ql_t, obs_t, t_seconds,
            upstream, chan, res_params, is_res, res_rows, gage_rows,
            decay_coeff, dt, res_da=res_da, da_states=da_states,
            month_i=month_i, return_courant=return_courant or gain_sweep,
            uplan=uplan, quc=quc, active_rows=active_rows,
            prev=raw if active_rows is not None else None, want_raw=True)
        ran = (None if active_rows is None
               else block_active_lanes(active_rows))
        if skip_tol is not None:
            quc_ref = quc if ran is None else torch.where(ran, quc, quc_ref)
        # the drive each lane's output was solved at: quc_ref, where the
        # skip kernel passed a lane's last output through
        drive = quc if skip_tol is None else quc_ref
        dq = q_new - q_est
        delta = torch.max(torch.abs(dq))
        q_est = q_new
        if gain_sweep:
            gain_k = accel_gain(raw.ck, raw.X, chan.dx, dt, q_new, g_prev,
                                drive, quc_prev, emp_ok=k >= 1)
            # a lane that was not solved keeps its last gain
            gain = gain_k if ran is None else torch.where(ran, gain_k, gain)
            if k == 0 and gain0 is not None:
                gain = torch.where(torch.isfinite(gain0)
                                   & (torch.abs(gain0) < 1.0), gain0, gain)
            gain = torch.where(is_res, 0.0, gain)
            if gage_rows.shape[0]:
                gain = gain.index_fill(0, gage_rows, 0.0)
            q_est = apply_linear_accel(q_est, dq, gain, usum, accel_lin)
        if compute_gain:
            quc_prev, g_prev = drive, q_new
    out = (q_est, v, d, res_elev_c, lo_val_c, lo_time_c, nudge, da_states_c,
           courant if return_courant else None, delta,
           torch.max(torch.abs(q_est)))
    return out + (gain,) if compute_gain else out


def _cols(a: torch.Tensor, width: int, fill=0) -> torch.Tensor:
    """[..., N] -> [..., width, ceil(N/width)], contiguous: node i lies in
    column i mod width, at row i // width, so each column solve gets
    contiguous lanes.  The layout's lanes past N hold ``fill``."""
    pad = -a.shape[-1] % width
    if pad:
        a = torch.cat([a, a.new_full(a.shape[:-1] + (pad,), fill)], dim=-1)
    return a.reshape(*a.shape[:-1], -1, width).transpose(-1, -2).contiguous()


class _GSStep(NamedTuple):
    """The inputs of one strict timestep that the GS column sweeps read,
    laid out once per step as [C, ceil(N/C)] (see ``_cols``): the lanes
    past N carry no flow, unit channel values, no upstream, no reservoir
    and no gage."""

    up_prev: torch.Tensor
    q: torch.Tensor
    depth: torch.Tensor
    ql: torch.Tensor
    chan: ChannelParams
    is_res: torch.Tensor
    masks: torch.Tensor         # [D, C, ceil(N/C)]
    up_res: torch.Tensor        # [n_res, K] upstream rows of reservoirs
    gmask: torch.Tensor | None  # gage lanes, and their obs / last obs
    obs: torch.Tensor | None
    lov: torch.Tensor | None
    lot: torch.Tensor | None


def _gs_step_inputs(q, depth, ql_t, obs_t, lo_val, lo_time, upstream,
                    chan: ChannelParams, is_res, res_rows, gage_rows,
                    uplan, width: int) -> _GSStep:
    n = q.shape[0]
    gage = [None] * 4
    if gage_rows.shape[0]:
        def scat(v, fill):
            return _cols(q.new_full((n,), fill).index_put((gage_rows,), v),
                         width, fill)
        gage = [_cols(torch.zeros(n, dtype=torch.bool, device=q.device)
                      .index_fill(0, gage_rows, True), width),
                scat(obs_t, float("nan")), scat(lo_val, float("nan")),
                scat(lo_time, 0.0)]
    return _GSStep(
        _cols(uplan(q), width), _cols(q, width), _cols(depth, width),
        _cols(ql_t, width),
        ChannelParams(*[_cols(c, width, 1.0) for c in chan]),
        _cols(is_res, width), _cols(uplan.masks, width),
        upstream[res_rows], *gage)


def _strict_gs_sweeps(q_est, g: _GSStep, res_elev, t_seconds: float,
                      res_params: LevelpoolParams, res_rows,
                      decay_coeff: float, dt: float, n_sweeps: int, uplan,
                      res_da=None, da_states=None,
                      month_i: int | None = None):
    """``n_sweeps`` Gauss-Seidel sweeps of one strict timestep
    (``troute_tpu/routing/engine.py:_strict_gs_sweep_kernel``).

    The post-order rows [N] are laid out as [ceil(N/C), C] (``_cols``); a
    sweep solves the C columns in turn, each over its ceil(N/C) rows.  A
    band source at displacement d <= c lies in the same row and reads this
    sweep's column c - d; other band sources, the remainder and the
    reservoirs read the previous iterate, so the splitting keeps the
    Jacobi fixed point.
    Reservoir outflows come once per sweep from the old iterate's inflows
    (candidate DA states discarded); nudging applies per column.  Returns
    (q_est, delta, qmax), the last two 0-d tensors on the device.
    """
    width = g.q.shape[0]
    n = q_est.shape[0]
    shifts = uplan.shifts
    lo = max(shifts)
    n_res = res_rows.shape[0]
    for _ in range(n_sweeps):
        q_old = q_est
        if n_res:
            inflow = torch.where(g.up_res >= 0,
                                 q_old[torch.clamp_min(g.up_res, 0)],
                                 0.0).sum(dim=1)
            outflow = _reservoirs(res_params, res_da, res_elev, inflow,
                                  da_states, t_seconds, month_i, dt)[0]
            overlay = _cols(q_old.new_zeros(n).index_put((res_rows,),
                                                         outflow), width)
        qx = torch.cat([q_old.new_zeros(lo), q_old])
        shifted_old = [_cols(qx[lo - d:lo - d + n], width) for d in shifts]
        rem = q_old.new_zeros(n)
        if uplan.rem_dst.shape[0]:
            rem = remainder_add(rem, q_old, uplan.rem_dst, uplan.rem_src,
                                uplan.rem_cuts)
        rem = _cols(rem, width)

        cols = []
        for c in range(width):
            quc_col = rem[c]
            for di, d in enumerate(shifts):
                src = cols[c - d] if d <= c else shifted_old[di][c]
                quc_col = quc_col + torch.where(g.masks[di, c], src, 0.0)
            out = muskingum_cunge_cuda(
                g.up_prev[c], quc_col, g.q[c], g.ql[c],
                *[p[c] for p in g.chan], g.depth[c], dt,
                with_diagnostics=False)
            col_q = torch.where(g.is_res[c], overlay[c] if n_res else g.q[c],
                                out.qdc)
            if g.gmask is not None:
                replaced = _nudge(col_q, t_seconds, decay_coeff, g.lov[c],
                                  g.lot[c], g.obs[c])[0]
                col_q = torch.where(g.gmask[c], replaced, col_q)
            cols.append(col_q)
        q_est = torch.stack(cols).t().reshape(-1)[:n]
        delta = torch.max(torch.abs(q_est - q_old))
    return q_est, delta, torch.max(torch.abs(q_est))


def route_stepped(net: NetworkArrays, chan: ChannelParams,
                  res_params: LevelpoolParams, cfg: RoutingConfig,
                  q0, depth0, res_elev0, qlat, da: GageDA | None = None,
                  res_da: ReservoirDAData | None = None,
                  collect: bool = True):
    """Host-stepped routing over ``cfg.nts`` steps.

    All tensors lie on ``q0.device`` in ``q0.dtype``.  ``qlat`` is
    [n_cols, N] lateral inflow, column (t-1) // qts_subdivisions.
    Returns a dict: 'flowveldepth' [nts, N, 3] (q, velocity, depth or
    elevation) when ``collect`` else None, 'nudge' [nts, n_gages],
    'courant' [nts, N, 3] (cn, ck, X) with ``cfg.return_courant``, and
    'state', the final ``RoutingState``.

    ``cfg.assume_short_ts`` runs the short-timestep step; otherwise
    ``cfg.strict_iterative`` runs the strict fixed-point form
    (``_route_strict``), which adds 'strict_sweeps' (sweeps per step) and
    'strict_mc_calls' (MC solves per kernel form) to the dict.  The
    level-scan strict form is ``route()``'s, as in the JAX package.
    """
    if not cfg.assume_short_ts and not cfg.strict_iterative:
        raise ValueError(
            "route_stepped supports short-timestep mode and the strict "
            "fixed-point mode (strict_iterative=True); the level-scan "
            "strict form is route()'s")
    return _drive(_route_short if cfg.assume_short_ts else _route_strict,
                  net, chan, res_params, cfg, q0, depth0, res_elev0, qlat,
                  da, res_da, collect, month_clip=True)


def route(net: NetworkArrays, chan: ChannelParams,
          res_params: LevelpoolParams, cfg: RoutingConfig,
          q0, depth0, res_elev0, qlat, da: GageDA | None = None,
          res_da: ReservoirDAData | None = None):
    """Route the network for ``cfg.nts`` steps: the JAX ``route()``, whose
    ``lax.scan`` over steps becomes a host loop.

    Inputs and the returned dict are ``route_stepped``'s (flows always
    collected).  The step form follows the config as in the JAX package:
    ``assume_short_ts`` the short step; else ``strict_iterative`` the
    fixed-point while loop (``_route_strict_iter``; accelerator "auto" is
    off here); else the level scan (``_route_levels``), which needs
    ``net.level_nodes``.  The strict forms add 'mc_calls', the MC solves
    made (on the card, each is one launch of kernel B1), and the
    fixed-point form 'strict_sweeps' (sweeps per step, the commit sweep
    not counted).
    """
    if cfg.assume_short_ts:
        driver = _route_short
    elif cfg.strict_iterative:
        driver = _route_strict_iter
    else:
        if net.level_nodes is None:
            raise ValueError("the level scan needs NetworkArrays.level_nodes "
                             "(network_arrays_from_topology(..., "
                             "need_levels=True))")
        driver = _route_levels
    return _drive(driver, net, chan, res_params, cfg, q0, depth0, res_elev0,
                  qlat, da, res_da, True, month_clip=False)


def da_handoff(da: GageDA | None, res_da: ReservoirDAData | None,
               state: RoutingState, steps: int, seconds: float) -> tuple:
    """The DA inputs of the next window, from those of a window of
    ``steps`` steps and ``seconds`` seconds and the ``state`` it ended
    in: (``GageDA`` or None, ``ReservoirDAData`` or None).

    The reference's run-set hand-off (``mc_reach.pyx:822-836`` subtracts
    the elapsed seconds from every DA clock): the gage observations drop
    the window's rows; the last observations are handed on, their times
    re-based to the next window's start; the hybrid, RFC and Great Lakes
    states are handed on with their clocks re-based (the Great Lakes keep
    their assimilated outflows, as ``great_lake.update_after_compute``
    does, ``DataAssimilation.py:751-791``); the reservoir observation
    times are re-based and the month table drops the window's steps,
    keeping at least its last entry (a short table clips to it).
    """
    if da is None and res_da is None:
        return da, res_da
    with span("engine.da_handoff"):
        if da is not None:
            da = da._replace(obs=da.obs[steps:],
                             lastobs_val=state.lastobs_val,
                             lastobs_time=state.lastobs_time - seconds)
        if res_da is not None:
            hyb, rfc, gl = state.hybrid, state.rfc, state.gl
            months = res_da.month_idx
            res_da = res_da._replace(
                hybrid_obs_time=res_da.hybrid_obs_time - seconds,
                gl_obs_time=res_da.gl_obs_time - seconds,
                month_idx=months[min(steps, months.shape[0] - 1):],
                hybrid_state0=hyb._replace(
                    update_time=hyb.update_time - seconds,
                    persistence_update_time=(hyb.persistence_update_time
                                             - seconds)),
                rfc_state0=rfc._replace(update_time=rfc.update_time - seconds),
                gl_state0=gl._replace(
                    assimilated_time=gl.assimilated_time - seconds,
                    update_time=gl.update_time - seconds))
    return da, res_da


def _drive(driver, net, chan, res_params, cfg, q0, depth0, res_elev0, qlat,
           da, res_da, collect, month_clip: bool):
    """Stage the DA inputs and run ``driver`` over the steps, inside the
    span ``engine.route`` (which also counts the device allocations made
    in it).  ``month_clip``: a month table shorter than the run clips to
    its last entry (the stepped drivers); else every month is 0
    (``route()``'s scan)."""
    device, dtype = q0.device, q0.dtype
    with span("engine.route"):
        allocs = device_allocs(device)
        have_da = da is not None and da.rows.shape[0] > 0
        empty = torch.zeros(0, dtype=dtype, device=device)
        gage_rows = (da.rows if have_da
                     else torch.zeros(0, dtype=torch.int64, device=device))
        lo_val = da.lastobs_val if have_da else empty
        lo_time = da.lastobs_time if have_da else empty
        decay = da.decay_coeff if have_da else 120.0
        n_obs_t = da.obs.shape[0] if have_da else 0
        nan_obs = (torch.full((da.obs.shape[1],), float("nan"), dtype=dtype,
                              device=device) if have_da else empty)
        # month per step, read once a call from the host tensor
        month_host = (res_da.month_idx.cpu().numpy() if res_da is not None
                      else None)
        if month_host is not None and not month_clip \
                and month_host.shape[0] <= cfg.nts:
            month_host = np.zeros(cfg.nts + 1, np.int64)

        def step_inputs(t: int):
            """The row selection of the JAX drivers: out-of-range qlat
            columns clamp, obs rows past the table are NaN."""
            col = min(max((t - 1) // cfg.qts_subdivisions, 0),
                      qlat.shape[0] - 1)
            obs_t = da.obs[t] if have_da and t < n_obs_t else nan_obs
            month_i = (int(month_host[min(t, month_host.shape[0] - 1)])
                       if res_da is not None else None)
            return qlat[col], obs_t, month_i

        da_states = (None if res_da is None else
                     (res_da.hybrid_state0, res_da.rfc_state0,
                      res_da.gl_state0))
        out = driver(net, chan, res_params, cfg, q0, depth0, res_elev0,
                     lo_val, lo_time, gage_rows, decay, res_da, da_states,
                     step_inputs, collect)
        end = device_allocs(device)
        if allocs is not None and end is not None:
            count("cuda.device_allocs", end - allocs)
    return out


def _result(cfg, q, depth, res_elev, lo_val, lo_time, da_states, collect,
            fvds, nudges, courants) -> dict:
    hyb, rfc, gl = da_states if da_states is not None else (None,) * 3
    state = RoutingState(q=q, depth=depth, res_elev=res_elev,
                         lastobs_val=lo_val, lastobs_time=lo_time,
                         hybrid=hyb, rfc=rfc, gl=gl)
    out = {"state": state, "flowveldepth": None, "nudge": None}
    if collect:
        with span("engine.collect"):
            out["flowveldepth"] = torch.stack(fvds)
            out["nudge"] = torch.stack(nudges)
            if cfg.return_courant:
                out["courant"] = torch.stack(courants)
    return out


def _np_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype.type


def _route_short(net, chan, res_params, cfg, q, depth, res_elev, lo_val,
                 lo_time, gage_rows, decay, res_da, da_states, step_inputs,
                 collect) -> dict:
    """The short-timestep steps of ``route_stepped``."""
    real = _np_dtype(q.dtype)
    fvds, nudges, courants = [], [], []
    for t in range(1, cfg.nts + 1):
        with span("engine.step"):
            ql_t, obs_t, month_i = step_inputs(t)
            # t and dt multiplied in the dtype, as the JAX short driver does
            t_seconds = float(real(t) * real(cfg.dt))
            (q, v, depth, res_elev, lo_val, lo_time, nudge, da_states,
             courant) = _one_short_step(
                q, depth, res_elev, lo_val, lo_time, ql_t, obs_t, t_seconds,
                net.upstream, chan, res_params, net.is_reservoir,
                net.res_rows, gage_rows, decay, cfg.dt, res_da=res_da,
                da_states=da_states, month_i=month_i,
                return_courant=cfg.return_courant, uplan=net.uplan)
            if collect:
                with span("engine.collect"):
                    fvds.append(torch.stack([q, v, depth], dim=-1))
                    nudges.append(nudge)
                    if cfg.return_courant:
                        courants.append(courant)
    return _result(cfg, q, depth, res_elev, lo_val, lo_time, da_states,
                   collect, fvds, nudges, courants)


def _route_strict(net, chan, res_params, cfg, q, depth, res_elev, lo_val,
                  lo_time, gage_rows, decay, res_da, da_states, step_inputs,
                  collect) -> dict:
    """The strict fixed-point steps of ``route_stepped``
    (``troute_tpu/routing/engine.py:1316-1507``).

    Each timestep starts from a quadratic extrapolation of the last three
    states, then runs sweeps in chunks; after each chunk the host reads
    ``delta`` and ``qmax`` in one transfer and stops once delta <=
    max(strict_tol, 4 eps qmax), or at ``strict_max_sweeps``.  Jacobi
    chunks (``_strict_sweeps``) take the linear accelerator when it is on,
    with an adaptive first-chunk size and tails of 3 sweeps, and the
    block-skip kernel when ``strict_block_skip`` is on (never in the first
    chunk of a run, which has no tolerance yet).  With ``strict_gs`` and a
    banded plan of positive shifts, GS chunks (``_strict_gs_sweeps``)
    iterate and one Jacobi sweep commits the state.  Any start converges
    to the same fixed point; only the sweep count changes.
    """
    dtype = q.dtype
    real = _np_dtype(dtype)
    eps4 = 4.0 * torch.finfo(dtype).eps
    sweeps_cfg = max(int(cfg.strict_sweep_chunk), 1)
    cap = int(cfg.strict_max_sweeps)
    uplan = net.uplan
    width = int(cfg.strict_gs_cols)
    use_gs = (_resolve_flag(cfg.strict_gs, False) and uplan is not None
              and len(uplan.shifts) > 0 and all(d > 0 for d in uplan.shifts))
    use_accel = (_accel_enabled(cfg, stepped=True) and not use_gs
                 and uplan is not None and cfg.strict_accel_lin > 0)
    use_skip = _resolve_flag(cfg.strict_block_skip, False) and not use_gs
    gs_chunk = max(1, sweeps_cfg // 8)
    tol_latest = None
    gain_carry = None
    sw_adapt, sw_streak, sw_fail = max(2, int(cfg.strict_accel_chunk)), 0, None
    sweep_counts = []
    calls = {"mc_secant": 0, "mc_secant_skip": 0}
    q_prev_step = q_prev2 = None
    fvds, nudges, courants = [], [], []

    def poll(delta, qmax):
        """The one device-to-host transfer of a chunk."""
        d_h, q_h = torch.stack([delta, qmax]).tolist()
        return d_h, max(cfg.strict_tol, eps4 * q_h)

    for t in range(1, cfg.nts + 1):
        ql_t, obs_t, month_i = step_inputs(t)
        # t * dt taken in Python and then cast, as the JAX strict driver
        t_seconds = float(real(t * cfg.dt))
        if q_prev_step is None:
            q_est = q
        elif q_prev2 is None:
            q_est = torch.clamp_min(2.0 * q - q_prev_step, 0.0)
        else:
            q_est = torch.clamp_min(3.0 * (q - q_prev_step) + q_prev2, 0.0)
        step = (q, depth, res_elev, lo_val, lo_time, ql_t, obs_t, t_seconds,
                net.upstream, chan, res_params, net.is_reservoir,
                net.res_rows, gage_rows, decay, cfg.dt)
        kw = dict(res_da=res_da, da_states=da_states, month_i=month_i)
        total = 0
        if use_gs:
            g = _gs_step_inputs(q, depth, ql_t, obs_t, lo_val, lo_time,
                                net.upstream, chan, net.is_reservoir,
                                net.res_rows, gage_rows, uplan, width)
            # reserve one sweep of the cap for the commit sweep
            while total < cap - 1:
                chunk = min(gs_chunk, cap - 1 - total)
                q_est, delta, qmax = _strict_gs_sweeps(
                    q_est, g, res_elev, t_seconds, res_params, net.res_rows,
                    decay, cfg.dt, chunk, uplan, **kw)
                total += chunk
                calls["mc_secant"] += chunk * width
                delta_h, tol_eff = poll(delta, qmax)
                if delta_h <= tol_eff:
                    break
            (q_est, v, d, res_elev_c, lo_val_c, lo_time_c, nudge_t,
             da_states_c, cour_t, delta, qmax) = _strict_sweeps(
                q_est, *step, 1, return_courant=cfg.return_courant,
                uplan=uplan, **kw)
            total += 1
            calls["mc_secant"] += 1
        else:
            sw = sw_adapt if use_accel else sweeps_cfg
            lin = int(cfg.strict_accel_lin) if use_accel else 0
            first_chunk = min(sw, cap)
            while True:
                # after a first-chunk miss the iterate is near converged,
                # so accelerated tails poll every 3 sweeps
                chunk = min(sw if (not use_accel or total == 0) else 3,
                            cap - total)
                accel_k = lin if chunk >= 3 else 0
                skip_t = (float(real(0.25 * tol_latest))
                          if use_skip and tol_latest is not None else None)
                res_k = _strict_sweeps(
                    q_est, *step, chunk, return_courant=cfg.return_courant,
                    uplan=uplan, accel_lin=accel_k,
                    gain0=gain_carry if accel_k else None, skip_tol=skip_t,
                    **kw)
                (q_est, v, d, res_elev_c, lo_val_c, lo_time_c, nudge_t,
                 da_states_c, cour_t, delta, qmax) = res_k[:11]
                if accel_k:
                    gain_carry = res_k[11]
                n_skip = max(chunk - 2, 0) if skip_t is not None else 0
                calls["mc_secant_skip"] += n_skip
                calls["mc_secant"] += chunk - n_skip
                total += chunk
                delta_h, tol_latest = poll(delta, qmax)
                if delta_h <= tol_latest or total >= cap:
                    break
            if use_accel:
                # after 3 one-chunk steps in a row try one sweep fewer; a
                # size that ever missed is not tried again
                if total <= first_chunk:
                    sw_streak += 1
                    if sw_streak >= 3 and sw_adapt > 3 \
                            and (sw_fail is None or sw_adapt - 1 > sw_fail):
                        sw_adapt -= 1
                        sw_streak = 0
                else:
                    sw_fail = first_chunk
                    sw_adapt = min(first_chunk + 1, cap)
                    sw_streak = 0
        sweep_counts.append(total)
        q_prev2, q_prev_step = q_prev_step, q
        q, depth, res_elev = q_est, d, res_elev_c
        lo_val, lo_time, da_states = lo_val_c, lo_time_c, da_states_c
        if collect:
            fvds.append(torch.stack([q, v, d], dim=-1))
            nudges.append(nudge_t)
            if cfg.return_courant:
                courants.append(cour_t)

    out = _result(cfg, q, depth, res_elev, lo_val, lo_time, da_states,
                  collect, fvds, nudges, courants)
    out["strict_sweeps"] = sweep_counts
    out["strict_mc_calls"] = calls
    return out


def _route_strict_iter(net, chan, res_params, cfg, q, depth, res_elev,
                       lo_val, lo_time, gage_rows, decay, res_da, da_states,
                       step_inputs, collect) -> dict:
    """``route()``'s fixed-point strict steps
    (``troute_tpu/routing/engine.py:703-801``).

    Each step sweeps from the previous step's flows: one Jacobi sweep
    (``_one_short_step`` at the iterate's upstream sums), then the host
    reads delta = max |dq| and qmax = max |q| (one transfer per sweep:
    the JAX while loop tests its condition after every sweep, and an extra
    sweep moves the iterate), until delta <= max(strict_tol, 4 eps qmax)
    or ``strict_max_sweeps``.  With the accelerator on, a sweep whose
    delta is above 4x that tolerance jumps by ``strict_accel_lin`` linear
    terms.  One commit sweep at the converged iterate gives the step's
    outputs and state.
    """
    dtype = q.dtype
    real = _np_dtype(dtype)
    eps4 = real(4.0) * real(torch.finfo(dtype).eps)
    tol0 = real(cfg.strict_tol)
    cap = int(cfg.strict_max_sweeps)
    lin = (int(cfg.strict_accel_lin)
           if _accel_enabled(cfg, stepped=False) else 0)
    is_res = net.is_reservoir

    def usum(v):
        return _upstream_sum_stepped(v, net.upstream, net.uplan)

    sweep_counts, mc_calls = [], 0
    fvds, nudges, courants = [], [], []
    for t in range(1, cfg.nts + 1):
        ql_t, obs_t, month_i = step_inputs(t)
        t_seconds = float(real(t) * real(cfg.dt))
        step = (q, depth, res_elev, lo_val, lo_time, ql_t, obs_t, t_seconds,
                net.upstream, chan, res_params, is_res, net.res_rows,
                gage_rows, decay, cfg.dt)
        kw = dict(res_da=res_da, da_states=da_states, month_i=month_i,
                  uplan=net.uplan)
        q_est, g_prev, u_prev = q, q, usum(q)
        k, delta, qmax = 0, np.inf, real(0.0)
        while k < cap and delta > max(tol0, eps4 * qmax):
            quc = usum(q_est)
            res_k = _one_short_step(*step, quc=quc, return_courant=lin > 0,
                                    want_raw=True, **kw)
            q_new, raw = res_k[0], res_k[-1]
            dq = q_new - q_est
            delta, qmax = torch.stack([torch.max(torch.abs(dq)),
                                       torch.max(torch.abs(q_new))]).tolist()
            delta, qmax = real(delta), real(qmax)
            q_est = q_new
            if lin and delta > real(4.0) * max(tol0, eps4 * qmax):
                gain = accel_gain(raw.ck, raw.X, chan.dx, cfg.dt, q_new,
                                  g_prev, quc, u_prev, emp_ok=k >= 1)
                gain = torch.where(is_res, 0.0, gain)
                if gage_rows.shape[0]:
                    gain = gain.index_fill(0, gage_rows, 0.0)
                q_est = apply_linear_accel(q_new, dq, gain, usum, lin)
            g_prev, u_prev = q_new, quc
            k += 1
        (q, v, depth, res_elev, lo_val, lo_time, nudge, da_states,
         courant) = _one_short_step(*step, quc=usum(q_est),
                                    return_courant=cfg.return_courant, **kw)
        sweep_counts.append(k)
        mc_calls += k + 1
        if collect:
            fvds.append(torch.stack([q, v, depth], dim=-1))
            nudges.append(nudge)
            if cfg.return_courant:
                courants.append(courant)
    out = _result(cfg, q, depth, res_elev, lo_val, lo_time, da_states,
                  collect, fvds, nudges, courants)
    out["strict_sweeps"] = sweep_counts
    out["mc_calls"] = mc_calls
    return out


_RES_DA_SHARED = ("hybrid_obs_time", "month_idx", "obs_lookback_hours",
                  "hybrid_state0", "rfc_state0", "gl_state0")


class _LevelRow(NamedTuple):
    """One row of the level scan: lanes [start, end) of the level order,
    and the reservoirs and gages it dispatches and nudges (None: none)."""

    start: int
    end: int
    rows: torch.Tensor                  # node rows of the lanes
    res_slots: torch.Tensor | None      # reservoir slots of this row
    res_node_rows: torch.Tensor | None
    res_pos: torch.Tensor | None        # their lanes in the level order
    res_params: LevelpoolParams | None
    res_da: ReservoirDAData | None
    gages: torch.Tensor | None          # gage indices of this row


def _level_rows(net: NetworkArrays, res_params, res_da, gage_rows, n: int,
                device) -> tuple[torch.Tensor, list[_LevelRow]]:
    """The level scan's lanes in schedule order and its rows, built once
    per call in O(N) from ``net.level_nodes``: which reservoirs
    and gages each row holds comes from one table of the row of each node
    (the JAX package loops over gages x levels x width,
    ``troute_tpu/routing/engine.py:446-464``).  Reservoirs and gages are
    dispatched per row on their own lanes, where the JAX scan runs all of
    them at every level and keeps the active ones: the per-lane results are
    the same, since both are lane-wise, and a level without any costs no
    launch."""
    ln = net.level_nodes
    valid = ln >= 0
    # the schedule can be wide and mostly padding (a dense level matrix):
    # only its row counts and the rows of reservoirs and gages come to the
    # host
    counts_t = valid.sum(dim=1)
    keep = counts_t > 0
    order_t = ln[valid]
    counts_t = counts_t[keep]
    row_idx = torch.arange(counts_t.shape[0], device=device) \
        .repeat_interleave(counts_t)
    row_of = torch.full((n,), -1, dtype=torch.int64, device=device) \
        .index_put((order_t,), row_idx)
    pos_of = torch.full((n,), -1, dtype=torch.int64, device=device) \
        .index_put((order_t,), torch.arange(order_t.shape[0], device=device))
    counts = counts_t.cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(counts)])
    res_rows = net.res_rows.cpu().numpy()
    res_row = row_of[net.res_rows].cpu().numpy()
    res_pos = pos_of[net.res_rows].cpu().numpy()
    g_row = row_of[gage_rows].cpu().numpy()

    def t64(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    def by_row(rows):
        """{schedule row: the indices of the items it holds}."""
        order = np.argsort(rows, kind="stable")
        keys, starts = np.unique(rows[order], return_index=True)
        ends = np.append(starts[1:], order.size)
        return {int(k): order[a:b] for k, a, b in zip(keys, starts, ends)}

    res_of, gages_of = by_row(res_row), by_row(g_row)
    none = np.zeros(0, np.int64)
    out = []
    for k in range(len(counts)):
        s, e = int(bounds[k]), int(bounds[k + 1])
        slots = res_of.get(k, none)
        gi = gages_of.get(k, none)
        res = [None] * 5
        if slots.size:
            st = t64(slots)
            sub_da = None
            if res_da is not None:
                sub_da = res_da._replace(**{
                    f: getattr(res_da, f)[st] for f in res_da._fields
                    if f not in _RES_DA_SHARED})
            res = [st, t64(res_rows[slots]), t64(res_pos[slots]),
                   LevelpoolParams(*[p[st] for p in res_params]), sub_da]
        out.append(_LevelRow(s, e, order_t[s:e], *res,
                             t64(gi) if gi.size else None))
    return order_t, out


def _take_states(states, idx):
    return tuple(None if s is None else type(s)(*[f[idx] for f in s])
                 for s in states)


def _put_states(states, idx, sub):
    return tuple(None if s is None else type(s)(*[
        f.index_put((idx,), g) for f, g in zip(s, u)])
        for s, u in zip(states, sub))


def _route_levels(net, chan, res_params, cfg, q, depth, res_elev, lo_val,
                  lo_time, gage_rows, decay, res_da, da_states, step_inputs,
                  collect) -> dict:
    """``route()``'s level-scan strict steps
    (``troute_tpu/routing/engine.py:604-701``).

    Within a step, row by row of the schedule: the rows' current-step
    upstream sums from the step's buffer (every upstream node sits at a
    lower level, so it is final), one MC solve on the rows' lanes (on the
    card one launch of B1 on the gathered lanes), the flows written back
    into the buffer, then the row's reservoirs (level pool and DA at the
    inflow just written) and its gages (nudged), so that the next rows
    read the dispatched and nudged flows.  The step's previous-state
    inputs are gathered into the level order once per step, so a row's
    inputs are slices.  Eager PyTorch costs about 8 launches per row
    without reservoirs or gages.
    """
    device, dtype = q.device, q.dtype
    real = _np_dtype(dtype)
    n = q.shape[0]
    order, rows = _level_rows(net, res_params, res_da, gage_rows, n, device)
    m = order.shape[0]
    sentinel = torch.where(net.upstream >= 0, net.upstream, n)
    up_lv = sentinel[order]
    up_res = sentinel[net.res_rows]
    chan_lv = ChannelParams(*[c[order] for c in chan])
    is_res_lv = net.is_reservoir[order]
    zero = q.new_zeros(1)
    n_g = gage_rows.shape[0]
    mc_calls = 0
    fvds, nudges, courants = [], [], []
    for t in range(1, cfg.nts + 1):
        ql_t, obs_t, month_i = step_inputs(t)
        t_seconds = float(real(t) * real(cfg.dt))
        up_prev = _upstream_sum_stepped(q, net.upstream, net.uplan)
        qup_lv, qd_lv, dp_lv, ql_lv = (a[order] for a in (up_prev, q, depth,
                                                           ql_t))
        # the step's buffer: q, then one zero that -1 upstream slots read
        q_cur = torch.cat([q, zero])
        v_lv, d_lv = q.new_empty(m), q.new_empty(m)
        c_lv = q.new_empty((m, 3)) if cfg.return_courant else None
        res_elev_c, states_c = res_elev, da_states
        lo_val_c, lo_time_c = lo_val.clone(), lo_time.clone()
        nudge = q.new_zeros(n_g)
        for r in rows:
            s, e = r.start, r.end
            out = muskingum_cunge_cuda(
                qup_lv[s:e], q_cur[up_lv[s:e]].sum(dim=1), qd_lv[s:e],
                ql_lv[s:e], *[c[s:e] for c in chan_lv], dp_lv[s:e], cfg.dt,
                with_diagnostics=cfg.return_courant)
            q_rows, v_rows, d_rows = out.qdc, out.velc, out.depthc
            if r.res_slots is not None:
                res_lane = is_res_lv[s:e]
                q_rows = torch.where(res_lane, qd_lv[s:e], q_rows)
                v_rows = torch.where(res_lane, 0.0, v_rows)
                d_rows = torch.where(res_lane, dp_lv[s:e], d_rows)
            q_cur.index_copy_(0, r.rows, q_rows)
            v_lv[s:e] = v_rows
            d_lv[s:e] = d_rows
            if c_lv is not None:
                c_lv[s:e] = torch.stack([out.cn, out.ck, out.X], dim=-1)
            if r.res_slots is not None:
                sl = r.res_slots
                sub_states = (None if states_c is None
                              else _take_states(states_c, sl))
                outflow, elev, d_scat, sub_states = _reservoirs(
                    r.res_params, r.res_da, res_elev_c[sl],
                    q_cur[up_res[sl]].sum(dim=1), sub_states, t_seconds,
                    month_i, cfg.dt)
                res_elev_c = res_elev_c.index_put((sl,), elev)
                if states_c is not None:
                    states_c = _put_states(states_c, sl, sub_states)
                q_cur.index_put_((r.res_node_rows,), outflow)
                d_lv.index_put_((r.res_pos,), d_scat)
            if r.gages is not None:
                gi = r.gages
                g_rows = gage_rows[gi]
                q_g, nudge_g, val_g, time_g = _nudge(
                    q_cur[g_rows], t_seconds, decay, lo_val_c[gi],
                    lo_time_c[gi], obs_t[gi])
                q_cur.index_put_((g_rows,), q_g)
                lo_val_c.index_put_((gi,), val_g)
                lo_time_c.index_put_((gi,), time_g)
                nudge.index_put_((gi,), nudge_g)
        mc_calls += len(rows)
        v = q.new_zeros(n).index_copy_(0, order, v_lv)
        depth = depth.clone().index_copy_(0, order, d_lv)
        q = q_cur[:n]
        res_elev, da_states = res_elev_c, states_c
        lo_val, lo_time = lo_val_c, lo_time_c
        if collect:
            fvds.append(torch.stack([q, v, depth], dim=-1))
            nudges.append(nudge)
            if c_lv is not None:
                courants.append(q.new_zeros((n, 3)).index_copy_(
                    0, order, c_lv))
    out = _result(cfg, q, depth, res_elev, lo_val, lo_time, da_states,
                  collect, fvds, nudges, courants)
    out["mc_calls"] = mc_calls
    return out

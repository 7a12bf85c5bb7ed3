"""Host-stepped sharded routing: this rank's shard, B1 and the halo
exchange, step by step.

Port of ``troute_tpu/parallel/stepped_engine.py``.  Each rank runs
``route_stepped``'s steps on its shard:

    banded local upstream sums  ->  B1 on every local row
    ->  halo exchange  ->  B1 again on the rank's boundary rows (rows with
    an upstream on another rank), with their full sums
    ->  reservoirs / typed DA / nudging

and a strict step sweeps to the fixed point with one exchange per sweep
and B1 once per sweep, on the sums that include the halo.  On the card
every MC solve is one launch of kernel B1 (``muskingum_cunge_cuda``); on
the CPU its plain version runs.  Kernel B2 is not on this path: the JAX
drivers call the MC kernel without ``active_rows``.

Every rank of the group issues the same collectives in the same order:
whether a step exchanges depends on the plan's global rounds (a rank with
no boundary rows of its own still takes part, since it may export), and a
strict step's sweeps stop on the group's maximum ``delta`` and ``qmax``,
read once per poll (one ``all_reduce(MAX)`` of both).

At world size 1 (no cut edges) a step does what ``route_stepped``'s does,
in the same order on the same rows (the shard's pad rows past the network
carry no edge, and its plan has the engine's shifts in the engine's
order), so the two agree bit for bit.  The JAX module's single-device fast path
(``_make_block_fn``'s plain jit, an answer to ``shard_map``'s overhead)
and its K-step unroll (an answer to dispatch latency) have no
counterpart.
"""

from __future__ import annotations

import torch

from troute_torch.ops.muskingum_cuda import muskingum_cunge_cuda
from troute_torch.parallel.group import Comm
from troute_torch.parallel.sharded_engine import (
    ShardedInputs, ShardedResDA, ShardedRunResult, make_exchange,
    make_interior_sum, perm_rounds, reservoir_update, zero_da_states)
from troute_torch.routing.engine import (ChannelParams, _apply_nudging,
                                         _np_dtype, _upstream_sum,
                                         accel_gain, apply_linear_accel)


class _Shard:
    """One rank's shard, set up once per run: the plan's pads cut off (one
    host read of the lane counts), the interior sum, the exchange, the
    boundary rows' gather plan."""

    def __init__(self, group, inp: ShardedInputs, res_da: ShardedResDA | None,
                 dt: float, qts: int, decay_coeff: float, exchange: str,
                 band_shifts):
        self.inp, self.dt, self.qts = inp, float(dt), int(qts)
        self.decay = float(decay_coeff)
        self.dtype = inp.q0.dtype
        self.real = _np_dtype(self.dtype)
        n_local = inp.q0.shape[0]
        self.keep = inp.valid & ~inp.is_reservoir
        n_res, n_g, n_b = (int(v) for v in torch.stack([
            (inp.res_slots >= 0).sum(), (inp.gage_slot >= 0).sum(),
            (inp.boundary_rows >= 0).sum()]).tolist())
        self.interior_sum = make_interior_sum(
            inp.upstream_local, n_local, band_shifts, inp.band_masks,
            inp.band_rem_dst, inp.band_rem_src)
        perms = perm_rounds(inp.perm_pairs)
        # cut edges anywhere in the group: every rank exchanges
        self.has_boundary = any(perms)
        self.exchange = (make_exchange(
            exchange, perms, inp.halo_src_dev.shape[0], inp.export_slot,
            inp.send_slot, inp.recv_pos, inp.halo_src_dev, inp.halo_src_pos,
            group) if self.has_boundary else None)
        b = inp.boundary_rows[:n_b]
        self.b = b if n_b else None
        self.up_b = inp.upstream_local[b]
        self.chan_b = ChannelParams(*[c[b] for c in inp.chan])
        self.res_slots = inp.res_slots[:n_res]
        self.res_params = type(inp.res_params)(
            *[p[:n_res] for p in inp.res_params])
        self.rda = None
        self.month = None
        if res_da is not None:
            self.rda = res_da._replace(**{
                f: _lanes(getattr(res_da, f), n_res)
                for f in ShardedResDA._fields
                if f not in ("hybrid_obs_time", "month_idx",
                             "obs_lookback_hours")})
            self.month = res_da.month_idx.cpu().numpy()
        self.n_res, self.n_g = n_res, n_g
        self.gage_slot = inp.gage_slot[:n_g]
        self.gage_obs = inp.gage_obs[:, :n_g]
        self.nan_obs = inp.q0.new_full((n_g,), float("nan"))
        self.mc_calls = 0

    def mc(self, up_prev, quc, q, ql, chan, depth, diag: bool = False):
        self.mc_calls += 1
        return muskingum_cunge_cuda(
            up_prev, quc, q, ql, chan.dx, chan.bw, chan.tw, chan.twcc,
            chan.n, chan.ncc, chan.cs, chan.s0, depth, self.dt,
            with_diagnostics=diag)

    def step_inputs(self, t: int):
        """(lateral inflow column, gage observations, month) of step t:
        out-of-range columns clamp, observations past the table are NaN,
        months past the table clip to its last entry."""
        qlat = self.inp.qlat
        col = min(max((t - 1) // self.qts, 0), qlat.shape[0] - 1)
        obs_t = (self.gage_obs[t] if t < self.gage_obs.shape[0]
                 else self.nan_obs)
        month_i = (None if self.month is None else
                   int(self.month[min(t, self.month.shape[0] - 1)]))
        return qlat[col], obs_t, month_i

    def sums_full(self, qv):
        """True upstream sums, cross-rank neighbours included: the
        interior sums, then the boundary rows' full gather after the
        exchange."""
        upv = self.interior_sum(qv)
        if self.has_boundary:
            halo = self.exchange(qv)
            if self.b is not None:
                upv = upv.index_put((self.b,), _upstream_sum(
                    torch.cat([qv, halo]), self.up_b))
        return upv

    def commit(self, out, q, depth, res_elev, lo_val, lo_time, das, inflow,
               ql_obs_month, t_seconds: float):
        """A step's solved rows, then reservoirs at ``inflow`` and nudging,
        from the carried-in state: (q, v, depth, res_elev, lo_val,
        lo_time, das, nudge), the lane vectors padded as the plan's."""
        _, obs_t, month_i = ql_obs_month
        q_new = torch.where(self.keep, out.qdc, q)
        v_new = torch.where(self.keep, out.velc, 0.0)
        d_new = torch.where(self.keep, out.depthc, depth)
        if self.n_res:
            sub = tuple(_lanes(s, self.n_res) for s in das)
            q_new, d_new, elev, sub = reservoir_update(
                q_new, d_new, res_elev[:self.n_res], inflow, self.res_slots,
                self.res_params, self.rda, sub if self.rda is not None
                else None, t_seconds, month_i, self.dt)
            res_elev = _put_lanes(res_elev, elev)
            if self.rda is not None:
                das = tuple(_put_lanes(s, u) for s, u in zip(das, sub))
        nudge = q.new_zeros(lo_val.shape[0])
        if self.n_g:
            q_new, nudge_g, lov, lot = _apply_nudging(
                q_new, self.gage_slot, t_seconds, self.decay,
                lo_val[:self.n_g], lo_time[:self.n_g], obs_t)
            nudge = _put_lanes(nudge, nudge_g)
            lo_val, lo_time = _put_lanes(lo_val, lov), _put_lanes(lo_time, lot)
        return q_new, v_new, d_new, res_elev, lo_val, lo_time, das, nudge


def _lanes(x, n: int):
    """The first ``n`` lanes of a lane vector or of each field of a state."""
    if isinstance(x, tuple):
        return type(x)(*[f[:n] for f in x])
    return x[:n]


def _put_lanes(full, head):
    """``full`` with its first lanes replaced by ``head`` (a vector or a
    state of vectors): the plan's pad lanes keep their values."""
    if isinstance(full, tuple):
        return type(full)(*[_put_lanes(f, h) for f, h in zip(full, head)])
    return torch.cat([head, full[head.shape[0]:]])


def _initial_states(inp: ShardedInputs, res_da: ShardedResDA | None):
    if res_da is not None:
        return (res_da.hyb0, res_da.rfc0, res_da.gl0)
    return zero_da_states(inp.res_slots.shape[0], device=inp.q0.device,
                          dtype=inp.q0.dtype)


def _result(sh: _Shard, fvds, nudges, state, das, **kw) -> ShardedRunResult:
    """A driver's ``ShardedRunResult``: the collected steps (fvd None when
    none were collected), the final state and DA lanes, the MC calls."""
    q, depth, res_elev, lo_val, lo_time = state
    return ShardedRunResult(
        fvd=torch.stack(fvds) if fvds else None,
        nudge=(torch.stack(nudges) if nudges
               else q.new_zeros((0, lo_val.shape[0]))),
        q=q, depth=depth, res_elev=res_elev, lo_val=lo_val, lo_time=lo_time,
        hyb=das[0], rfc=das[1], gl=das[2], mc_calls=sh.mc_calls, **kw)


def route_sharded_stepped(group, inp: ShardedInputs, dt: float, nts: int,
                          qts_subdivisions: int = 1,
                          res_da: ShardedResDA | None = None,
                          decay_coeff: float = 120.0,
                          exchange: str = "neighbor",
                          band_shifts: tuple | None = None,
                          collect: bool = True) -> ShardedRunResult:
    """Short-timestep routing of this rank's shard over ``nts`` steps.

    ``group`` is the process group (None: the default group); every rank
    calls this with its own ``inp`` (and ``res_da``) from one plan.  Each
    step solves every local row with B1 on the interior sums; where the
    plan has cut edges, the exchange follows, and the rank's boundary rows
    are solved again with their full sums.  Returns this rank's
    ``ShardedRunResult`` (``fvd`` None unless ``collect``)."""
    sh = _Shard(group, inp, res_da, dt, qts_subdivisions, decay_coeff,
                exchange, band_shifts)
    q, depth, res_elev = inp.q0, inp.depth0, inp.res_elev0
    lo_val, lo_time = inp.gage_lo_val, inp.gage_lo_time
    das = _initial_states(inp, res_da)
    fvds, nudges = [], []
    for t in range(1, nts + 1):
        step = sh.step_inputs(t)
        ql_t = step[0]
        # t and dt multiplied in the dtype, as the short drivers do
        t_seconds = float(sh.real(t) * sh.real(dt))
        up_prev = sh.interior_sum(q)
        out = sh.mc(up_prev, up_prev, q, ql_t, inp.chan, depth)
        if sh.has_boundary:
            halo = sh.exchange(q)
            if sh.b is not None:
                b = sh.b
                up_prev_b = _upstream_sum(torch.cat([q, halo]), sh.up_b)
                out_b = sh.mc(up_prev_b, up_prev_b, q[b], ql_t[b], sh.chan_b,
                              depth[b])
                out = out._replace(
                    qdc=out.qdc.index_put((b,), out_b.qdc),
                    velc=out.velc.index_put((b,), out_b.velc),
                    depthc=out.depthc.index_put((b,), out_b.depthc))
                up_prev = up_prev.index_put((b,), up_prev_b)
        (q, v, depth, res_elev, lo_val, lo_time, das, nudge) = sh.commit(
            out, q, depth, res_elev, lo_val, lo_time, das, up_prev, step,
            t_seconds)
        nudges.append(nudge)
        if collect:
            fvds.append(torch.stack([q, v, depth], dim=-1))
    return _result(sh, fvds, nudges, (q, depth, res_elev, lo_val, lo_time),
                   das)


def route_sharded_strict_stepped(group, inp: ShardedInputs, dt: float,
                                 nts: int, qts_subdivisions: int = 1,
                                 res_da: ShardedResDA | None = None,
                                 decay_coeff: float = 120.0,
                                 exchange: str = "neighbor",
                                 band_shifts: tuple | None = None,
                                 strict_tol: float = 1e-9,
                                 strict_max_sweeps: int = 64,
                                 sweep_chunk: int = 8, accel_lin: int = 8,
                                 collect: bool = True) -> ShardedRunResult:
    """Strict fixed-point routing of this rank's shard: host-polled sweeps
    of B1 with one halo exchange per sweep (the JAX driver's controller).

    Each step starts from the 2q_{t-1} - q_{t-2} (then quadratic)
    extrapolation and runs chunks of sweeps; after each chunk the group's
    max |dq| of the chunk's last sweep and max |q| come to the host in one
    ``all_reduce(MAX)``, and the step ends when delta <= max(strict_tol,
    4 eps qmax) or at ``strict_max_sweeps``.  With ``accel_lin`` and a
    banded plan, chunks of at least 3 sweeps jump by ``accel_lin`` linear
    terms between sweeps, the gain zeroed on boundary, reservoir and gage
    rows (shard-local: Gauss-accelerated within a shard, Jacobi across),
    the first chunk adapts its size (down after 3 one-chunk steps, never
    back to a size that missed) and later chunks run 3 sweeps.  Reservoir
    and nudging candidates are recomputed each sweep from the previous
    step's state, so the last sweep's are committed.  Returns this rank's
    ``ShardedRunResult`` with ``strict_sweeps``."""
    sh = _Shard(group, inp, res_da, dt, qts_subdivisions, decay_coeff,
                exchange, band_shifts)
    comm = Comm(group, inp.q0.device)
    dtype = inp.q0.dtype
    q, depth, res_elev = inp.q0, inp.depth0, inp.res_elev0
    lo_val, lo_time = inp.gage_lo_val, inp.gage_lo_time
    das = _initial_states(inp, res_da)
    eps4 = 4.0 * float(torch.finfo(dtype).eps)
    use_accel = accel_lin > 0 and band_shifts is not None
    # the gain's zero rows: not solved here (pads, reservoirs), boundary
    # rows (their upstream residual lives on other ranks) and gages
    gain_keep = sh.keep.clone()
    if sh.b is not None:
        gain_keep[sh.b] = False
    if sh.n_g:
        gain_keep[sh.gage_slot] = False
    fvds, nudges, sweeps = [], [], []
    sw_adapt, sw_streak, sw_fail = max(sweep_chunk, 1), 0, None
    q_prev_step = q_prev2 = None
    for t in range(1, nts + 1):
        step = sh.step_inputs(t)
        ql_t = step[0]
        t_seconds = float(sh.real(t) * sh.real(dt))
        if q_prev_step is None:
            q_est = q
        elif q_prev2 is None:
            q_est = torch.clamp_min(2.0 * q - q_prev_step, 0.0)
        else:
            q_est = torch.clamp_min(3.0 * (q - q_prev_step) + q_prev2, 0.0)
        up_prev = sh.sums_full(q)
        total = 0
        first_chunk = min(sw_adapt, strict_max_sweeps)
        while True:
            sw_t = first_chunk if (not use_accel or total == 0) else 3
            chunk = min(max(sw_t, 1), strict_max_sweeps - total)
            lin = int(accel_lin) if use_accel and chunk >= 3 else 0
            quc_prev = g_prev = None
            for k in range(chunk):
                want_gain = lin > 0 and k < chunk - 1
                quc = sh.sums_full(q_est)
                out = sh.mc(up_prev, quc, q, ql_t, inp.chan, depth,
                            diag=want_gain)
                res_k = sh.commit(out, q, depth, res_elev, lo_val, lo_time,
                                  das, quc, step, t_seconds)
                q_new = res_k[0]
                dq = q_new - q_est
                q_est = q_new
                if want_gain:
                    gain = accel_gain(out.ck, out.X, inp.chan.dx, dt, q_new,
                                      g_prev, quc, quc_prev, emp_ok=k >= 1)
                    gain = torch.where(gain_keep, gain, 0.0)
                    q_est = apply_linear_accel(q_est, dq, gain,
                                               sh.interior_sum, lin)
                quc_prev, g_prev = quc, q_new
            total += chunk
            # the last sweep's delta and max flow over the group: one read
            delta, qmax = comm.all_max(torch.stack(
                [torch.max(torch.abs(dq)), torch.max(torch.abs(q_new))]))
            if delta <= max(strict_tol, eps4 * qmax) \
                    or total >= strict_max_sweeps:
                break
        if use_accel:
            if total <= first_chunk:
                sw_streak += 1
                if sw_streak >= 3 and sw_adapt > 3 \
                        and (sw_fail is None or sw_adapt - 1 > sw_fail):
                    sw_adapt -= 1
                    sw_streak = 0
            else:
                sw_fail = first_chunk
                sw_adapt = min(first_chunk + 1, strict_max_sweeps)
                sw_streak = 0
        sweeps.append(total)
        q_prev2, q_prev_step = q_prev_step, q
        (q, v, depth, res_elev, lo_val, lo_time, das, nudge) = res_k
        nudges.append(nudge)
        if collect:
            fvds.append(torch.stack([q, v, depth], dim=-1))
    return _result(sh, fvds, nudges, (q, depth, res_elev, lo_val, lo_time),
                   das, strict_sweeps=sweeps)

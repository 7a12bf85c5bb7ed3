"""Multi-GPU routing on ``torch.distributed``: one process per GPU, one
shard of the network per rank.

Port of ``troute_tpu/parallel/sharded_engine.py``.  The JAX module runs
every shard from one program, ``shard_map`` over a device mesh; here each
rank of a process group holds its own shard on its own device, and the
mesh's collectives become ``torch.distributed`` calls:

* the halo exchange's per-round ``ppermute`` (``make_exchange``,
  ``"neighbor"``) becomes one ``dist.batch_isend_irecv`` holding every
  round's messages: the plan's rounds exist to make each ``ppermute`` a
  permutation, and point-to-point messages between distinct pairs need no
  such order.  ``"allgather"`` is ``dist.all_gather`` (the list form, which
  every torch version here has);
* the fixed-point sweeps' ``lax.pmax`` of delta and qmax is one
  ``dist.all_reduce(MAX)`` of a 2-element tensor per poll
  (``stepped_engine.py``).

A group's backend decides how a message travels, never a failure: NCCL
sends the card's buffers; gloo sends host tensors only, so under gloo
with tensors on the card the exchange copies its send buffers to the host
and what it receives back to the card (``group.Comm``).  Which form ran is
logged.

Every rank builds the same [n_dev, ...] NumPy plan (``partition.py`` and
``build_sharded_inputs``) and keeps its own row on its device, so one
rank's ``ShardedInputs`` and ``ShardedResDA`` have no leading device axis.
The plan's -1 pads (reservoir, gage and boundary lanes, remainder edges)
always trail the real entries; the drivers cut them off once per run.

``route_sharded`` has no in-scan form: in JAX the scan/stepped split
exists because a Pallas kernel cannot run inside ``lax.scan``.  It and
``route_sharded_global`` run the host-stepped drivers of
``stepped_engine.py``.  JAX's placement API, ``input_specs`` and
``place_global``, has no counterpart: a rank places its own row when it
builds it.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.ops.reservoir_da import (
    GreatLakesDAState, HybridDAState, RfcDAState)
from troute_torch.parallel.group import Comm, group_rank
from troute_torch.parallel.partition import NetworkPartition, scatter_to_shards
from troute_torch.routing.engine import (ChannelParams, RoutingState,
                                         _accel_enabled, _reservoirs,
                                         _upstream_sum)
from troute_torch.routing.upstream_plan import UpstreamOp

LOG = logging.getLogger(__name__)


class ShardedResDA(NamedTuple):
    """One rank's reservoir-DA lanes ([R, ...]), ``ReservoirDAData`` sliced
    to the rank's reservoirs in ``ShardedInputs.res_slots`` order; the
    observation times of the hybrid series and the months are shared."""

    wbody_type: torch.Tensor          # int32 [R]
    hybrid_obs: torch.Tensor          # [R, n_hobs]
    hybrid_obs_time: torch.Tensor     # [n_hobs]
    hyb0: HybridDAState               # [R] lanes
    rfc_series: torch.Tensor          # [R, n_counts]
    rfc_counts: torch.Tensor          # int32 [R]
    rfc_use: torch.Tensor             # bool [R]
    rfc_timestep: torch.Tensor        # [R]
    rfc_persist_seconds: torch.Tensor
    rfc0: RfcDAState
    gl_obs: torch.Tensor              # [R, n_gobs]
    gl_obs_time: torch.Tensor
    gl_climatology: torch.Tensor      # [R, 12]
    gl0: GreatLakesDAState
    month_idx: torch.Tensor           # int32 [nts+1], on the host
    obs_lookback_hours: float


class ShardedInputs(NamedTuple):
    """One rank's row of the sharded plan and inputs, on its device."""

    upstream_local: torch.Tensor   # int64 [n_local, K] into the extended array
    export_slot: torch.Tensor      # int64 [E]
    halo_src_dev: torch.Tensor     # int64 [H]
    halo_src_pos: torch.Tensor     # int64 [H]
    perm_pairs: np.ndarray         # int64 [n_rounds, n_pairs, 2], every rank's
    send_slot: torch.Tensor        # int64 [n_rounds, W]
    recv_pos: torch.Tensor         # int64 [n_rounds, W]
    boundary_rows: torch.Tensor    # int64 [B] (-1 pad)
    valid: torch.Tensor            # bool [n_local] (pad rows False)
    is_reservoir: torch.Tensor     # bool [n_local]
    res_slots: torch.Tensor        # int64 [R] local slots of reservoirs, -1 pad
    chan: ChannelParams            # [n_local] each
    res_params: LevelpoolParams    # [R] each
    q0: torch.Tensor               # [n_local]
    depth0: torch.Tensor           # [n_local]
    res_elev0: torch.Tensor        # [R]
    qlat: torch.Tensor             # [n_cols, n_local]
    # streamflow-nudging DA, rank-local lanes (-1 = pad slot)
    gage_slot: torch.Tensor        # int64 [G]
    gage_index: torch.Tensor       # int64 [G] global gage ordinal (-1 pad)
    gage_obs: torch.Tensor         # [nts+1, G] (NaN = missing)
    gage_lo_val: torch.Tensor      # [G]
    gage_lo_time: torch.Tensor     # [G]
    # per-shard banded upstream plan (partition._banded_local_plans); the
    # shift tuple travels separately (the drivers' band_shifts)
    band_masks: torch.Tensor       # bool [D, n_local] (D may be 0)
    band_rem_dst: torch.Tensor     # int64 [E] (-1 pad)
    band_rem_src: torch.Tensor     # int64 [E]


class ShardedRunResult(NamedTuple):
    """One rank's outputs of a sharded run.  ``mc_calls`` counts the MC
    solves this rank made (on the card, each is one launch of kernel B1);
    the strict driver adds ``strict_sweeps``, the sweeps of each step."""

    fvd: torch.Tensor | None       # [nts, n_local, 3]
    nudge: torch.Tensor            # [nts, G]
    q: torch.Tensor                # [n_local] final flows
    depth: torch.Tensor            # [n_local]
    res_elev: torch.Tensor         # [R]
    lo_val: torch.Tensor           # [G]
    lo_time: torch.Tensor          # [G]
    hyb: HybridDAState             # [R] lanes
    rfc: RfcDAState
    gl: GreatLakesDAState
    mc_calls: int = 0
    strict_sweeps: list | None = None


def sharded_plan(part: NetworkPartition, topo, chan_np: dict,
                 res_params_np: np.ndarray | None, q0, depth0,
                 res_elev_by_row: dict, qlat_cols: np.ndarray,
                 gage_rows=None, gage_obs=None, gage_lo_val=None,
                 gage_lo_time=None) -> dict:
    """Every rank's inputs as [n_dev, ...] float64/int64 NumPy arrays (the
    JAX ``build_sharded_inputs``), by ``ShardedInputs`` field; ``chan``
    and ``res_params`` are dicts of their fields.

    ``res_params_np`` is [n_res, >=8] in ``topo.reservoir_rows`` order, in
    the network builder's column order (area, max_depth, orifice_area,
    orifice_coeff, orifice_elev, weir_coeff, weir_elev, weir_length, ...);
    the dam length is 10 m, as ``LevelpoolParams.from_array`` sets it.
    The JAX function reads a ninth column as the dam length, and the JAX
    command line hands it the builder's array, whose ninth column is the
    initial fill fraction (ROADMAP C4).
    """
    nd, nl = part.n_dev, part.n_local
    valid = part.global_row >= 0

    is_res_global = (topo.node_type == 1)
    is_res = np.zeros((nd, nl), bool)
    is_res[valid] = is_res_global[part.global_row[valid]]

    # per-rank reservoir slot lists
    res_lists = [np.flatnonzero(is_res[d]) for d in range(nd)]
    R = max(max((len(r) for r in res_lists), default=0), 1)
    res_slots = np.full((nd, R), -1, np.int64)
    res_p = np.ones((nd, R, 9), np.float64)
    res_e0 = np.zeros((nd, R), np.float64)
    if res_params_np is not None:
        slot_of_global = {int(r): i for i, r in enumerate(topo.reservoir_rows)}
        for d in range(nd):
            for i, s in enumerate(res_lists[d]):
                g = int(part.global_row[d, s])
                res_slots[d, i] = s
                res_p[d, i, :8] = res_params_np[slot_of_global[g]][:8]
                res_p[d, i, 8] = 10.0
                res_e0[d, i] = res_elev_by_row.get(g, 0.0)

    def shard(a, fill=0.0):
        return scatter_to_shards(part, np.asarray(a, np.float64), fill)

    # gage DA lanes: each gage lives on exactly one rank (its owner)
    n_obs_t = gage_obs.shape[0] if gage_obs is not None else 1
    per_dev = [[] for _ in range(nd)]
    if gage_rows is not None and len(gage_rows):
        for gi, g in enumerate(np.asarray(gage_rows)):
            per_dev[part.owner[g]].append((int(part.local_slot[g]), gi))
    G = max(1, max(len(p) for p in per_dev))
    gslot = np.full((nd, G), -1, np.int64)
    gindex = np.full((nd, G), -1, np.int64)
    gobs = np.full((nd, n_obs_t, G), np.nan)
    glov = np.full((nd, G), np.nan)
    glot = np.zeros((nd, G))
    for d in range(nd):
        for k, (slot, gi) in enumerate(per_dev[d]):
            gslot[d, k] = slot
            gindex[d, k] = gi
            gobs[d, :, k] = np.asarray(gage_obs)[:, gi]
            if gage_lo_val is not None:
                glov[d, k] = np.asarray(gage_lo_val)[gi]
                glot[d, k] = np.asarray(gage_lo_time)[gi]

    qlat_cols = np.asarray(qlat_cols)
    return dict(
        upstream_local=part.upstream_local, export_slot=part.export_slot,
        halo_src_dev=part.halo_src_dev, halo_src_pos=part.halo_src_pos,
        perm_pairs=part.perm_pairs, send_slot=part.send_slot,
        recv_pos=part.recv_pos, boundary_rows=part.boundary_rows,
        valid=valid, is_reservoir=is_res, res_slots=res_slots,
        chan={k: shard(chan_np[k], 1.0) for k in ChannelParams._fields},
        res_params={k: res_p[:, :, i]
                    for i, k in enumerate(LevelpoolParams._fields)},
        q0=shard(q0), depth0=shard(depth0), res_elev0=res_e0,
        qlat=np.stack([shard(qlat_cols[c])
                       for c in range(qlat_cols.shape[0])]),
        gage_slot=gslot, gage_index=gindex, gage_obs=gobs, gage_lo_val=glov,
        gage_lo_time=glot,
        band_masks=(part.band_masks if part.band_masks is not None
                    else np.zeros((nd, 0, nl), bool)),
        band_rem_dst=(part.band_rem_dst if part.band_rem_dst is not None
                      else np.full((nd, 1), -1, np.int32)),
        band_rem_src=(part.band_rem_src if part.band_rem_src is not None
                      else np.zeros((nd, 1), np.int32)))


def rank_inputs(plan: dict, rank: int, *, device, dtype) -> ShardedInputs:
    """Row ``rank`` of ``sharded_plan``'s arrays as ``ShardedInputs``:
    floats in ``dtype``, indices int64, masks bool; ``qlat`` is [n_cols,
    n_local] and ``gage_obs`` [nts+1, G]."""
    def t(a):
        a = np.asarray(a)
        kind = (dtype if a.dtype.kind == "f" else
                torch.bool if a.dtype == bool else torch.int64)
        return torch.as_tensor(a, dtype=kind, device=device)

    vals = {}
    for f in ShardedInputs._fields:
        v = plan[f]
        if f == "perm_pairs":
            vals[f] = np.asarray(v, np.int64)
        elif f == "chan":
            vals[f] = ChannelParams(**{k: t(v[k][rank]) for k in v})
        elif f == "res_params":
            vals[f] = LevelpoolParams(**{k: t(v[k][rank]) for k in v})
        elif f == "qlat":
            vals[f] = t(v[:, rank])
        else:
            vals[f] = t(v[rank])
    return ShardedInputs(**vals)


def build_sharded_inputs(part: NetworkPartition, topo, chan_np: dict,
                         res_params_np: np.ndarray | None, q0, depth0,
                         res_elev_by_row: dict, qlat_cols: np.ndarray, *,
                         rank: int, device, dtype=torch.float32,
                         gage_rows=None, gage_obs=None, gage_lo_val=None,
                         gage_lo_time=None) -> ShardedInputs:
    """Rank ``rank``'s inputs on ``device`` from global host arrays.

    Args:
        chan_np: dict of [N] float arrays (dx, bw, tw, twcc, n, ncc, cs, s0)
        res_params_np: see ``sharded_plan``
        res_elev_by_row: {global_row: initial elevation}
        qlat_cols: [n_cols, N]
    """
    plan = sharded_plan(part, topo, chan_np, res_params_np, q0, depth0,
                        res_elev_by_row, qlat_cols, gage_rows, gage_obs,
                        gage_lo_val, gage_lo_time)
    return rank_inputs(plan, rank, device=device, dtype=dtype)


def shard_reservoir_da(part: NetworkPartition, topo, res_da, res_slots, *,
                       rank: int, device, dtype=torch.float32
                       ) -> ShardedResDA:
    """Rank ``rank``'s lanes of a global ``ReservoirDAData`` ([n_res]
    lanes ordered by ``topo.reservoir_rows``, tensors or arrays), in the
    order of its ``res_slots`` ([R], -1 pad)."""
    res_slots = np.asarray(torch.as_tensor(res_slots).cpu())
    slot_of_global = {int(r): i for i, r in enumerate(topo.reservoir_rows)}
    lanes = [(i, slot_of_global[int(part.global_row[rank, s])])
             for i, s in enumerate(res_slots) if s >= 0]

    def host(a):
        return np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)

    def t(a):
        kind = dtype if a.dtype.kind == "f" else None
        return torch.as_tensor(a, dtype=kind, device=device)

    def take(a, fill=0.0):
        a = host(a)
        out = np.full((res_slots.size,) + a.shape[1:], fill, a.dtype)
        for i, g in lanes:
            out[i] = a[g]
        return t(out)

    def take_state(s):
        return type(s)(*[take(f) for f in s])

    return ShardedResDA(
        wbody_type=take(res_da.wbody_type, 1),
        hybrid_obs=take(res_da.hybrid_obs, np.nan),
        hybrid_obs_time=t(host(res_da.hybrid_obs_time)),
        hyb0=take_state(res_da.hybrid_state0),
        rfc_series=take(res_da.rfc_series),
        rfc_counts=take(res_da.rfc_counts, 0),
        rfc_use=take(res_da.rfc_use, False),
        rfc_timestep=take(res_da.rfc_timestep, 1.0),
        rfc_persist_seconds=take(res_da.rfc_persist_seconds),
        rfc0=take_state(res_da.rfc_state0),
        gl_obs=take(res_da.gl_obs, np.nan),
        gl_obs_time=take(res_da.gl_obs_time),
        gl_climatology=take(res_da.gl_climatology),
        gl0=take_state(res_da.gl_state0),
        month_idx=torch.as_tensor(host(res_da.month_idx)),
        obs_lookback_hours=float(res_da.obs_lookback_hours))


def make_interior_sum(up, n_local: int, band_shifts, band_masks,
                      band_rem_dst, band_rem_src):
    """Local-only upstream-sum callable (halo contributions 0; boundary
    rows are summed again after the exchange).  The banded masked-shift
    form (``upstream_plan.banded_upstream_sum``) when a ``band_shifts``
    plan exists (its remainder regrouped in layers as ``UpstreamOp``
    regroups it, through the host once), the masked gather otherwise."""
    if band_shifts is None:
        local_up = torch.where((up >= 0) & (up < n_local), up, -1)
        return lambda q: _upstream_sum(q, local_up)
    dst = band_rem_dst.cpu().numpy()
    keep = dst >= 0
    return UpstreamOp.from_arrays(band_masks, dst[keep],
                                  band_rem_src.cpu().numpy()[keep],
                                  band_shifts, device=band_masks.device)


def make_exchange(exchange: str, perms, n_halo: int, export_slot, send_slot,
                  recv_pos, halo_src_dev, halo_src_pos, group=None):
    """Halo-exchange callable: cross-shard boundary values of ``q`` into
    this rank's [n_halo] halo layout.  ``"neighbor"`` posts every round's
    messages of this rank (``perms``: per round, the (source, destination)
    group ranks) in one ``batch_isend_irecv``; ``"allgather"`` gathers
    every rank's exported values.  Both fill the same slots with the same
    values, bit for bit.  Every rank of the group calls it the same number
    of times, whether or not it sends or receives."""
    if exchange not in ("neighbor", "allgather"):
        raise ValueError(f"unknown exchange {exchange!r}")
    comm = Comm(group, export_slot.device)
    device = export_slot.device
    LOG.info("halo exchange: %s", comm.describe(exchange))
    if exchange == "allgather":
        src_dev = torch.clamp_min(halo_src_dev, 0)
        has = halo_src_dev >= 0

        def exchange_allgather(q):
            all_exp = torch.stack(comm.all_gather(q[export_slot]))  # [D, E]
            return torch.where(has, all_exp[src_dev, halo_src_pos], 0.0)
        return exchange_allgather

    sends, recvs = [], []
    for r, pairs in enumerate(perms):
        for s, d in pairs:
            if s == comm.rank:
                sends.append((comm.peer(d), send_slot[r]))
            if d == comm.rank:
                pos = recv_pos[r]
                keep = torch.nonzero(pos >= 0).flatten()
                recvs.append((comm.peer(s), pos[keep], keep))
    width = send_slot.shape[-1]

    def exchange_neighbor(q):
        halo = q.new_zeros(n_halo)
        ops = [dist.P2POp(dist.isend, comm.out(q[slots]), peer,
                          group=group) for peer, slots in sends]
        bufs = [torch.empty(width, dtype=q.dtype,
                            device="cpu" if comm.staged else device)
                for _ in recvs]
        ops += [dist.P2POp(dist.irecv, buf, peer, group=group)
                for buf, (peer, _, _) in zip(bufs, recvs)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for buf, (_, pos, keep) in zip(bufs, recvs):
            halo = halo.index_put((pos,), comm.back(buf)[keep])
        return halo
    return exchange_neighbor


def perm_rounds(perm_pairs) -> tuple:
    """The plan's exchange rounds as tuples of (source, destination)."""
    perm_np = np.asarray(perm_pairs)
    return tuple(tuple((int(s), int(d)) for s, d in perm_np[r] if s >= 0)
                 for r in range(perm_np.shape[0]))


def reservoir_update(q_new, d_new, res_elev, inflow_src, res_slots,
                     res_params, rda, da_states, t_seconds: float,
                     month_i, dt: float):
    """Level pool, then the typed reservoir DA when ``rda`` is given, on
    the rank's reservoir lanes (pads cut off), scattered into the local
    flows and depths.  ``inflow_src`` is the upstream-sum vector the
    reservoirs read (the previous step's sums in short mode, the
    iterate's in strict mode)."""
    outflow, elev, d_scat, da_states = _reservoirs(
        res_params, rda, res_elev, inflow_src[res_slots], da_states,
        t_seconds, month_i, dt)
    return (q_new.index_put((res_slots,), outflow),
            d_new.index_put((res_slots,), d_scat), elev, da_states)


def zero_da_states(R: int, *, device, dtype):
    """Placeholder DA state lanes when no reservoir DA runs."""
    z = torch.zeros(R, dtype=dtype, device=device)
    return (HybridDAState(z, z, z, z),
            RfcDAState(torch.zeros(R, dtype=torch.int32, device=device), z),
            GreatLakesDAState(z, z, z))


def route_sharded(group, inp: ShardedInputs, dt: float, nts: int,
                  qts_subdivisions: int = 1,
                  res_da: ShardedResDA | None = None,
                  decay_coeff: float = 120.0, exchange: str = "neighbor",
                  band_shifts: tuple | None = None, strict: bool = False,
                  strict_tol: float = 1e-9, strict_max_sweeps: int = 64,
                  accel_lin: int = 0) -> ShardedRunResult:
    """Sharded routing run of this rank's shard (the JAX function's
    arguments, a process group for the mesh).  ``strict`` runs the
    fixed-point sweeps with a halo exchange per sweep
    (``route_sharded_strict_stepped``, in chunks of 8 sweeps with the
    accelerator, of 16 without); the default is the short-timestep mode,
    one exchange per step (``route_sharded_stepped``)."""
    from troute_torch.parallel.stepped_engine import (
        route_sharded_stepped, route_sharded_strict_stepped)
    kw = dict(qts_subdivisions=qts_subdivisions, res_da=res_da,
              decay_coeff=decay_coeff, exchange=exchange,
              band_shifts=band_shifts)
    if strict:
        return route_sharded_strict_stepped(
            group, inp, dt, nts, strict_tol=strict_tol,
            strict_max_sweeps=strict_max_sweeps,
            sweep_chunk=8 if accel_lin else 16, accel_lin=accel_lin, **kw)
    return route_sharded_stepped(group, inp, dt, nts, **kw)


def route_sharded_fvd(group, inp: ShardedInputs, dt: float, nts: int, **kw):
    """``route_sharded`` returning only the fvd tensor."""
    return route_sharded(group, inp, dt, nts, **kw).fvd


class _Assembly:
    """Where each rank's padded rows and lanes land in the global arrays."""

    def __init__(self, part: NetworkPartition, topo, plan: dict):
        flat = part.global_row.reshape(-1)
        self.src = np.flatnonzero(flat >= 0)
        self.dst = flat[self.src]
        self.n = part.owner.size
        # reservoir lanes: (rank, lane) of each global reservoir slot
        slots = plan["res_slots"]                             # [D, R]
        slot_of_global = {int(r): i for i, r in
                          enumerate(topo.reservoir_rows)}
        n_res = topo.reservoir_rows.size
        self.res_src = np.zeros(n_res, np.int64)
        for d in range(slots.shape[0]):
            for i, s in enumerate(slots[d]):
                if s >= 0:
                    g = int(part.global_row[d, s])
                    self.res_src[slot_of_global[g]] = d * slots.shape[1] + i
        gidx = plan["gage_index"].reshape(-1)                 # [D * G]
        self.g_src = np.flatnonzero(gidx >= 0)
        self.g_dst = gidx[self.g_src]

    def rows(self, parts: list[torch.Tensor], axis: int) -> torch.Tensor:
        """Per-rank [..., n_local, ...] tensors (node axis ``axis``) to
        the global [..., N, ...] tensor."""
        return self.lanes(parts, self.src, self.dst, self.n, axis)

    @staticmethod
    def lanes(parts: list[torch.Tensor], src: np.ndarray, dst: np.ndarray,
              size: int, axis: int = 0) -> torch.Tensor:
        """The ranks' lanes (``parts`` joined along ``axis``) at positions
        ``src`` placed at ``dst`` of a new axis of ``size`` (zeros
        elsewhere)."""
        allr = torch.cat(parts, dim=axis)
        shape = list(allr.shape)
        shape[axis] = size
        out = allr.new_zeros(shape)
        idx = (slice(None),) * axis
        out[idx + (torch.as_tensor(dst, device=allr.device),)] = \
            allr[idx + (torch.as_tensor(src, device=allr.device),)]
        return out


def route_sharded_global(group, topo, chan_np: dict, res_params_np, cfg,
                         q0, depth0, res_elev0, qlat_cols, da=None,
                         res_da=None, part: NetworkPartition | None = None,
                         dtype=torch.float32, device=None,
                         exchange: str = "neighbor") -> dict:
    """Sharded routing with the ``route()`` contract on GLOBAL arrays.

    Every rank of ``group`` (None: the default group) calls it with the
    same global inputs (arrays or tensors; ``da`` a ``GageDA``, ``res_da``
    a ``ReservoirDAData``).  It partitions the network over the group's
    ranks (greedy basin packing unless ``part`` is given), builds this
    rank's shard on ``device`` (default: ``q0``'s device when it is a
    tensor, else the current CUDA device), runs the stepped driver of
    ``cfg``'s mode (short, or the strict fixed point with the
    accelerator as ``cfg.strict_accel`` says), gathers every rank's shard
    and returns the same dict on every rank: ``{"flowveldepth": [nts, N,
    3], "nudge": [nts, G], "state": RoutingState}`` on ``device``, so the
    command line's run-set loop hands state across sets as with the
    single-device engine.  It also holds 'mc_calls' (this rank's MC
    solves) and, in strict mode, 'strict_sweeps'.
    """
    from troute_torch.parallel.partition import partition_network
    from troute_torch.parallel.stepped_engine import (
        route_sharded_stepped, route_sharded_strict_stepped)

    if not cfg.assume_short_ts and not cfg.strict_iterative:
        raise ValueError(
            "route_sharded_global supports short-timestep mode and the "
            "strict fixed-point form (strict_iterative=True); the "
            "level-scan strict form is single-device only")
    if device is None:
        device = (q0.device if isinstance(q0, torch.Tensor)
                  else torch.device("cuda", torch.cuda.current_device()))
    device = torch.device(device)
    rank, world = group_rank(group)
    if part is None:
        part = partition_network(topo, world)
    if part.n_dev != world:
        raise ValueError(f"partition for {part.n_dev} ranks, group of {world}")

    def host(a):
        return np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor)
                          else a, np.float64)

    res_rows = np.asarray(topo.reservoir_rows)
    elev0_h = host(res_elev0)
    res_elev_by_row = {int(r): float(elev0_h[i]) for i, r in
                       enumerate(res_rows)}
    have_da = da is not None and int(da.rows.shape[0]) > 0
    plan = sharded_plan(
        part, topo, chan_np,
        host(res_params_np) if res_params_np is not None else None,
        host(q0), host(depth0), res_elev_by_row, host(qlat_cols),
        gage_rows=np.asarray(host(da.rows), np.int64) if have_da else None,
        gage_obs=host(da.obs) if have_da else None,
        gage_lo_val=host(da.lastobs_val) if have_da else None,
        gage_lo_time=host(da.lastobs_time) if have_da else None)
    inp = rank_inputs(plan, rank, device=device, dtype=dtype)
    rda = None
    if res_da is not None:
        rda = shard_reservoir_da(part, topo, res_da, inp.res_slots,
                                 rank=rank, device=device, dtype=dtype)

    kw = dict(qts_subdivisions=cfg.qts_subdivisions, res_da=rda,
              decay_coeff=(da.decay_coeff if have_da else 120.0),
              exchange=exchange, band_shifts=part.band_shifts)
    if cfg.assume_short_ts:
        res = route_sharded_stepped(group, inp, cfg.dt, cfg.nts, **kw)
    else:
        accel = _accel_enabled(cfg, stepped=True)
        res = route_sharded_strict_stepped(
            group, inp, cfg.dt, cfg.nts, strict_tol=cfg.strict_tol,
            strict_max_sweeps=cfg.strict_max_sweeps,
            sweep_chunk=(cfg.strict_accel_chunk if accel
                         else cfg.strict_sweep_chunk),
            accel_lin=cfg.strict_accel_lin if accel else 0, **kw)

    # ---- every rank's shard, assembled into the global arrays ----
    comm = Comm(group, device)
    asm = _Assembly(part, topo, plan)
    fvd = asm.rows(comm.all_gather(res.fvd), axis=1)
    qd = asm.rows(comm.all_gather(torch.stack([res.q, res.depth])), axis=1)
    n_g = int(da.rows.shape[0]) if have_da else 0
    empty = torch.zeros(0, dtype=dtype, device=device)
    nudge = torch.zeros((cfg.nts, n_g), dtype=dtype, device=device)
    lov, lot = empty, empty
    if have_da:
        g = asm.lanes(comm.all_gather(torch.cat(
            [res.nudge, res.lo_val[None], res.lo_time[None]])),
            asm.g_src, asm.g_dst, n_g, axis=1)
        nudge, lov, lot = g[:cfg.nts], g[cfg.nts], g[cfg.nts + 1]
    n_res = res_rows.size
    states = (res.hyb, res.rfc, res.gl)
    if n_res:
        fl = asm.lanes(comm.all_gather(torch.stack(
            [res.res_elev, *res.hyb, res.rfc.update_time, *res.gl])),
            asm.res_src, np.arange(n_res), n_res, axis=1)
        idx = asm.lanes(comm.all_gather(res.rfc.timeseries_idx),
                        asm.res_src, np.arange(n_res), n_res)
        relev = fl[0]
        states = (HybridDAState(*fl[1:5]), RfcDAState(idx, fl[5]),
                  GreatLakesDAState(*fl[6:9]))
    else:
        relev = torch.as_tensor(elev0_h, dtype=dtype, device=device)
    hyb, rfc, gl = states if res_da is not None else (None, None, None)
    state = RoutingState(q=qd[0], depth=qd[1], res_elev=relev,
                         lastobs_val=lov, lastobs_time=lot, hybrid=hyb,
                         rfc=rfc, gl=gl)
    out = {"flowveldepth": fvd, "nudge": nudge, "state": state,
           "mc_calls": res.mc_calls}
    if res.strict_sweeps is not None:
        out["strict_sweeps"] = res.strict_sweeps
    return out

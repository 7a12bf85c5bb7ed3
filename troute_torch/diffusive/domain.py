"""Diffusive domain assembly: reach lists and geometry to padded tensors.

Port of ``troute_tpu/diffusive/domain.py`` (the reference marshals this in
``diffusive_utils_v02.diffusive_input_data_v02``): reaches right-aligned
into [R, C] tensors, the wavefront corrector's node schedule from the
reach tree, and the stacking of independent domains for batched runs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from troute_torch.diffusive.solver import (
    SO_LLM, DiffusiveDomain, DiffusiveState, attach_uniform_tables)
from troute_torch.diffusive.xsection import (
    build_xsec_table_natural, build_xsec_tables, build_xsec_tables_torch)

# domains of at least this many nodes build their tables on the device
DEVICE_TABLES_MIN_NODES = 2048


def build_domain(reach_nodes: Sequence[dict], ds_reach: Sequence[int],
                 qlat_series: np.ndarray, dt_qlat: float,
                 trib_series: np.ndarray, dt_trib: float,
                 dtini_given: float, *, device, dtype=torch.float64,
                 natural_xsec: dict | None = None,
                 db_depth: np.ndarray | None = None,
                 dt_db: float = 3600.0,
                 nel_uniform: int | None = None) -> DiffusiveDomain:
    """Assemble a ``DiffusiveDomain`` on ``device``; arguments as in
    ``troute_tpu/diffusive/domain.py:build_domain``.  Domains of
    ``DEVICE_TABLES_MIN_NODES`` nodes or more without surveyed sections
    build their tables on the device (``build_xsec_tables_torch``),
    smaller ones with the NumPy builder."""
    R = len(reach_nodes)
    ncomp = np.array([len(r["z"]) for r in reach_nodes], np.int64)
    C = int(ncomp.max())
    head_col = C - ncomp

    def right_align(key, fill):
        out = np.full((R, C), fill, np.float64)
        for j, r in enumerate(reach_nodes):
            out[j, C - ncomp[j]:] = r[key]
        return out

    z = right_align("z", 0.0)
    dx = right_align("dx", 1.0)
    # pad dx so padded columns don't produce zero divisions
    dx = np.where(dx <= 0, 1.0, dx)
    bo = right_align("bo", 1.0)
    traps = right_align("traps", 1.0)
    tw = right_align("tw", 3.0)
    twcc = right_align("twcc", 9.0)
    mann = right_align("mann", 0.05)
    manncc = right_align("manncc", 0.1)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), device=device).to(dt)

    if natural_xsec is None and z.size >= DEVICE_TABLES_MIN_NODES:
        tab, z_adj = build_xsec_tables_torch(z, bo, traps, tw, twcc, mann,
                                             manncc, dx, device=device,
                                             dtype=dtype)
    else:
        tab, z_adj = build_xsec_tables(z, bo, traps, tw, twcc, mann, manncc,
                                       dx)
        if natural_xsec:
            # nodes with surveyed bathymetry take natural tables wholesale,
            # then the uniform-flow column with the adjusted datums
            for (ri, ni), (xb, zb, nb) in natural_xsec.items():
                col = C - ncomp[ri] + ni
                t_nat, z_datum = build_xsec_table_natural(xb, zb, nb)
                tab[ri, col] = t_nat
                z_adj[ri, col] = z_datum
            slope = np.zeros((R, C))
            if C > 1:
                slope[:, :-1] = (z_adj[:, :-1] - z_adj[:, 1:]) \
                    / np.maximum(dx[:, :-1], 1e-12)
                slope[:, -1] = (z_adj[:, -2] - z_adj[:, -1]) \
                    / np.maximum(dx[:, -2], 1e-12)
            slope = np.maximum(slope, SO_LLM)
            for (ri, ni) in natural_xsec:
                col = C - ncomp[ri] + ni
                tab[ri, col, 9] = tab[ri, col, 4] * np.sqrt(slope[ri, col])
        tab = dev(tab)

    valid = np.zeros((R, C), bool)
    for j in range(R):
        valid[j, C - ncomp[j]:] = True

    ds = np.asarray(ds_reach, np.int64)
    K = max(1, int(np.bincount(ds[ds >= 0], minlength=R).max()
                   if (ds >= 0).any() else 1))
    up = np.full((R, K), -1, np.int64)
    fill = np.zeros(R, np.int64)
    for j, d in enumerate(ds):
        if d >= 0:
            up[d, fill[d]] = j
            fill[d] += 1

    # corrector node schedule: reach r starts after its downstream reach
    # has finished its node chain; one node per reach per global step
    start = np.full(R, -1, np.int64)
    for j in range(R):
        path = []
        k = j
        while k >= 0 and start[k] < 0:
            path.append(k)
            k = ds[k]
        base = 0 if k < 0 else start[k] + int(ncomp[k])
        for m in reversed(path):
            start[m] = base
            base += int(ncomp[m])
    D = int((start + ncomp).max())
    bwd_active = np.zeros((D, R), bool)
    bwd_col = np.zeros((D, R), np.int64)
    for j in range(R):
        for k in range(int(ncomp[j])):
            bwd_active[start[j] + k, j] = True
            bwd_col[start[j] + k, j] = C - 1 - k

    if qlat_series is None:
        qlat_series = np.zeros((2, R, C))
    # duplicate the first row: the reference's qlat time array holds the
    # first value over [t0, t0+dt] (diffusive.f90:494-499)
    qlat_series = np.concatenate([qlat_series[:1], qlat_series], axis=0)
    if trib_series is None:
        trib_series = np.zeros((2, R))

    idx = torch.int64
    dom = DiffusiveDomain(
        z=dev(z_adj), dx=dev(dx), ncomp=dev(ncomp, idx),
        head_col=dev(head_col, idx), valid=dev(valid, torch.bool),
        xsec=tab, ds_reach=dev(ds, idx), up_reaches=dev(up, idx),
        bwd_active=dev(bwd_active, torch.bool), bwd_col=dev(bwd_col, idx),
        trib_q=dev(trib_series), dt_trib=float(dt_trib),
        qlat=dev(qlat_series), dt_qlat=float(dt_qlat),
        dtini_given=float(dtini_given),
        db_depth=None if db_depth is None else dev(db_depth),
        dt_db=float(dt_db), xsec_min=tab.amin(dim=-1))
    if nel_uniform:
        dom = attach_uniform_tables(dom, nel_u=int(nel_uniform))
    return dom


def _extend_series(arr: torch.Tensor, n_t: int) -> torch.Tensor:
    """Pad a time series to n_t rows along its last segment's slope, which
    ``_interp_series`` extrapolates anyway: the same values everywhere."""
    if arr.shape[0] >= n_t:
        return arr
    slope = (arr[-1] - arr[-2] if arr.shape[0] >= 2
             else torch.zeros_like(arr[-1]))
    k = torch.arange(1, n_t - arr.shape[0] + 1, dtype=arr.dtype,
                     device=arr.device)
    tail = arr[-1][None] + k.reshape((-1,) + (1,) * (arr.dim() - 1)) \
        * slope[None]
    return torch.cat([arr, tail])


def _pad_edge(a: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """[R, C, ...]: ``cols`` edge copies on the left of the column axis,
    then the last reach repeated ``rows`` times."""
    if cols:
        a = torch.cat([a[:, :1].expand(-1, cols, *a.shape[2:]), a], 1)
    if rows:
        a = torch.cat([a, a[-1:].expand(rows, *a.shape[1:])])
    return a


def stack_domains(doms: Sequence[DiffusiveDomain]) -> DiffusiveDomain:
    """Stack B independent domains into one batched domain ([B, R, C]) for
    ``run_diffusive_batched``, padded as
    ``troute_tpu/diffusive/domain.py:stack_domains`` pads them: columns on
    the left and reaches at the end as edge copies with ``valid`` False
    and ``ds_reach`` -1, series extended along their last segment; the
    scalar timesteps and dtype must match."""
    if not doms:
        raise ValueError("stack_domains needs at least one domain")
    d0 = doms[0]
    for d in doms[1:]:
        for f in ("dt_trib", "dt_qlat", "dtini_given", "dt_db"):
            if getattr(d, f) != getattr(d0, f):
                raise ValueError(f"domains disagree on {f}")
        if d.z.dtype != d0.z.dtype:
            raise ValueError("domains disagree on dtype")
    C = max(int(d.n_cols) for d in doms)
    R = max(int(d.n_reaches) for d in doms)
    K = max(d.up_reaches.shape[1] for d in doms)
    D = max(d.bwd_active.shape[0] for d in doms)
    n_tq = max(d.trib_q.shape[0] for d in doms)
    n_ql = max(d.qlat.shape[0] for d in doms)
    any_db = any(d.db_depth is not None for d in doms)
    n_db = max((d.db_depth.shape[1] for d in doms
                if d.db_depth is not None), default=0)
    dtype = d0.z.dtype

    def pad(d: DiffusiveDomain) -> dict:
        dC = C - int(d.n_cols)
        dR = R - int(d.n_reaches)
        xsec = _pad_edge(d.xsec, dR, dC)
        if d.db_depth is not None:
            db = d.db_depth
            db = torch.cat([db, db[:, -1:].expand(-1, n_db - db.shape[1])], 1)
            db = torch.cat([db, db[-1:].expand(dR, -1)])
        elif any_db:
            db = torch.full((R, n_db), torch.nan, dtype=dtype,
                            device=d.z.device)
        else:
            db = None
        qlat = _extend_series(d.qlat, n_ql)
        qlat = _pad_edge(qlat.permute(1, 2, 0), dR, dC).permute(2, 0, 1)
        return dict(
            z=_pad_edge(d.z, dR, dC), dx=_pad_edge(d.dx, dR, dC),
            ncomp=F.pad(d.ncomp, (0, dR), value=1),
            head_col=F.pad(d.head_col + dC, (0, dR), value=C - 1),
            valid=F.pad(d.valid, (dC, 0, 0, dR), value=False), xsec=xsec,
            ds_reach=F.pad(d.ds_reach, (0, dR), value=-1),
            up_reaches=F.pad(d.up_reaches,
                             (0, K - d.up_reaches.shape[1], 0, dR),
                             value=-1),
            bwd_active=F.pad(d.bwd_active,
                             (0, dR, 0, D - d.bwd_active.shape[0]),
                             value=False),
            bwd_col=F.pad(d.bwd_col + dC, (0, dR, 0, D - d.bwd_col.shape[0]),
                          value=C - 1),
            trib_q=F.pad(_extend_series(d.trib_q, n_tq), (0, dR), value=0.0),
            qlat=qlat, db_depth=db, xsec_min=xsec.amin(dim=-1))

    padded = [pad(d) for d in doms]

    def stk(key):
        return (None if padded[0][key] is None
                else torch.stack([p[key] for p in padded]))

    out = DiffusiveDomain(
        z=stk("z"), dx=stk("dx"), ncomp=stk("ncomp"),
        head_col=stk("head_col"), valid=stk("valid"), xsec=stk("xsec"),
        ds_reach=stk("ds_reach"), up_reaches=stk("up_reaches"),
        bwd_active=stk("bwd_active"), bwd_col=stk("bwd_col"),
        trib_q=stk("trib_q"), dt_trib=d0.dt_trib, qlat=stk("qlat"),
        dt_qlat=d0.dt_qlat, dtini_given=d0.dtini_given,
        db_depth=stk("db_depth"), dt_db=d0.dt_db, xsec_min=stk("xsec_min"))
    if any(d.utab is not None for d in doms):
        # uniform tables are re-derived after stacking: a padded resampled
        # grid would shift its lo/step, and resampling again is exact
        nel_u = max(d.utab.shape[-1] for d in doms if d.utab is not None)
        out = attach_uniform_tables(out, nel_u=nel_u)
    return out


def stack_states(sts, doms: Sequence[DiffusiveDomain], C: int, R: int
                 ) -> DiffusiveState:
    """Stack per-domain states to match ``stack_domains`` padding."""
    def pad_state(s, d):
        dC = C - int(d.n_cols)
        dR = R - int(d.n_reaches)
        return [_pad_edge(a, dR, dC) for a in s[:5]]

    ps = [pad_state(s, d) for s, d in zip(sts, doms)]
    return DiffusiveState(
        *[torch.stack([p[k] for p in ps]) for k in range(5)],
        t=torch.stack([torch.as_tensor(s.t, dtype=sts[0].q.dtype,
                                       device=sts[0].q.device)
                       for s in sts]))

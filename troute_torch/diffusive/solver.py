"""Batched Crank-Nicolson diffusive-wave solver in PyTorch.

Port of ``troute_tpu/diffusive/solver.py``, which reproduces the
reference's Tulane diffusive core (``kernel/diffusive/diffusive.f90:diffnw``)
as vector steps over all mainstem reaches at once, in a padded [R, C]
layout with reaches right-aligned (node i of a reach with ``ncomp`` nodes
at column ``C - ncomp + i``):

* the predictor (``mesh_diffusive_forward``) is reach-parallel: the
  forward elimination and the back substitution run along the node axis,
  either as C sequential column steps (``predictor_seq``, the executable
  spec) or as doubling scans (``_forward_elim_assoc``, ``_linear_scan``);
* the corrector (``mesh_diffusive_backward``) chains water-surface
  elevations downstream to upstream: node by node over the reach tree
  (``corrector``, reference parity), or as a fixed-point iteration over
  all nodes at once (``corrector_jacobi``), with a Newton/bisection depth
  solve (``_rtsafe_vec``) per node;
* the adaptive internal timestep comes from the global CFL bound
  (``calculateDT``), read on the host once per sub-step.

The JAX package compiles its loops (``lax.scan``, ``while_loop``); here
they are host loops of eager tensor ops.  Where a loop's exit depends on
the data the host reads the condition: the corrector's sweep loop once per
sweep, the time loop once per sub-step, ``rtsafe`` before each Newton iteration
(an extra iteration would leave a converged lane as it is, so the result
is the JAX while loop's either way).  ``run_diffusive(..., stats=dict)``
counts them.

Batched domains ([B, R, C], ``domain.stack_domains``) run as one [B*R, C]
domain whose reaches carry their domain's index (``group``): each domain
keeps its own time, timestep and corrector convergence, and a finished
domain holds its state, as the JAX package's ``vmap`` of its while loops
does, so a batched run equals solo runs.

Every tensor of a domain lies on one device in one float dtype (float64 is
the reference precision).  TPU workarounds of the JAX package are not
copied: the one-hot table fetches become gathers (``_fetch_last``), the
searches ``torch.searchsorted``, and the f64 size guard
(``guard_f64_domain``) goes.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

# solver parameters (reference defaults, diffusive_utils_v02.py:742-753)
CFL = 0.95
C_LLM = 0.5
D_LLM = 10.0
D_ULM = 10000.0
Q_LLM = 0.02831
SO_LLM = 0.0001
THETA = 1.0
DTINI_DIVISOR = 10.0

COL_ELEV, COL_AREA, COL_PERI, COL_RADI, COL_CONV, COL_TOPW = 0, 1, 2, 3, 4, 5
COL_I1, COL_DPDA, COL_DKDA, COL_UNIFORM, COL_SKK = 6, 7, 8, 9, 10

# columns of the resampled uniform-elevation-grid table (``utab``)
UCOL_CONV, UCOL_DKDA, UCOL_TOPW, UCOL_SKK = 0, 1, 2, 3
NEL_UNIFORM = 128

# predictor form when the caller names none: "assoc" (doubling scans) or
# "seq" (C sequential column steps); the environment variable as in the
# JAX package
PREDICTOR_ENV = "TROUTE_DIFF_PREDICTOR"
PREDICTOR_DEFAULT = "assoc"

# Newton/bisection iterations of rtsafe at most
RTSAFE_MAX_ITERS = 40


class DiffusiveDomain(NamedTuple):
    """Static domain tensors.  [R, C] node arrays right-aligned (see
    ``troute_tpu/diffusive/solver.py:DiffusiveDomain`` for each field)."""

    z: torch.Tensor            # bed elevation (notch-adjusted datum)
    dx: torch.Tensor           # [R, C] length node i -> i+1 (pad 1.0)
    ncomp: torch.Tensor        # int64 [R]
    head_col: torch.Tensor     # int64 [R] = C - ncomp
    valid: torch.Tensor        # bool [R, C]
    xsec: torch.Tensor         # [R, C, 11, nel]
    ds_reach: torch.Tensor     # int64 [R] downstream reach (-1 = tailwater)
    up_reaches: torch.Tensor   # int64 [R, K] upstream reaches (-1 pad)
    bwd_active: torch.Tensor   # bool [D, R] wavefront corrector schedule
    bwd_col: torch.Tensor      # int64 [D, R]
    trib_q: torch.Tensor       # [n_tq, R] tributary inflow per reach head
    dt_trib: float
    qlat: torch.Tensor         # [n_ql, R, C] lateral inflow series
    dt_qlat: float
    dtini_given: float         # routing dt (s)
    db_depth: torch.Tensor | None = None   # [R, n_db] coastal depth series
    dt_db: float = 3600.0
    xsec_min: torch.Tensor | None = None   # [R, C, 11] column minima
    utab: torch.Tensor | None = None       # [R, C, 4, nel_u]
    ugrid_lo: torch.Tensor | None = None   # [R, C]
    ugrid_step: torch.Tensor | None = None  # [R, C] sqrt-space spacing
    utab_min: torch.Tensor | None = None   # [R, C, 4]

    @property
    def n_reaches(self):
        return self.z.shape[-2]

    @property
    def n_cols(self):
        return self.z.shape[-1]


class DiffusiveState(NamedTuple):
    q: torch.Tensor            # [R, C] discharge
    y: torch.Tensor            # [R, C] water-surface elevation
    qpx: torch.Tensor          # [R, C] dQ/dx term
    celerity: torch.Tensor     # [R, C]
    diffusivity: torch.Tensor  # [R, C]
    t: torch.Tensor            # 0-d model time (s since t0); [B] batched


def _count(stats, key, n=1):
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _per_reach(v):
    """A time or timestep: 0-d for one domain, [R] per reach when
    batched; returned ready to broadcast against [R, C]."""
    return v[:, None] if v.dim() == 1 else v


def _interp_series(series, dt_series, t, start_offset=0.0):
    """Linear interpolation of a [n_t, R, ...] series at time ``t`` (0-d,
    or [R] per reach), with first/last-segment linear extrapolation like
    the reference's ``intp_y`` (diffusive.f90:2671-2699)."""
    n = series.shape[0]
    pos = (t - start_offset) / dt_series
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 2)
    w = pos - i0.to(pos.dtype)
    if t.dim() == 0:
        return series[i0] * (1.0 - w) + series[i0 + 1] * w
    rows = torch.arange(series.shape[1], device=series.device)
    if series.dim() == 3:
        w = w[:, None]
    return series[i0, rows] * (1.0 - w) + series[i0 + 1, rows] * w


def _fetch_last(arr, idx):
    """``arr[..., nel]`` at per-lane index ``idx[...]``."""
    return torch.gather(arr, -1, idx.unsqueeze(-1)).squeeze(-1)


def _search_right(grid, x):
    """Per-lane ``searchsorted(grid[lane], x[lane], side="right")``."""
    return torch.searchsorted(grid, x.unsqueeze(-1).contiguous(),
                              right=True).squeeze(-1)


def _count_le(xarr, x):
    """Entries of ``xarr[..., :]`` <= ``x[...]``: the JAX package's
    compare-all count, which differs from a binary search where the grid
    is not sorted (the squared-depth grid inside the notch)."""
    return (xarr <= x.unsqueeze(-1)).sum(dim=-1)


def _ugrid_bracket(lo, step, x, nel_u):
    """Bracket (idx, w) on the sqrt-stretched grid whose knot k sits at
    lo + (k step)^2; the weight is linear in elevation between knots."""
    pos = torch.sqrt(torch.clamp_min(x - lo, 0.0)) / step
    idx = torch.clamp(torch.floor(pos), 0, nel_u - 2).to(torch.int64)
    fidx = idx.to(x.dtype)
    e1 = lo + (fidx * step) ** 2
    e2 = lo + ((fidx + 1.0) * step) ** 2
    w = (x - e1) / torch.clamp_min(e2 - e1, 1e-30)
    return idx, w


def _bracket_rows(tab, idx):
    """Entries ``idx`` and ``idx + 1`` of every column of ``tab`` [...,
    n_cols, nel] at per-lane ``idx`` [...]: two [..., n_cols] tensors, in
    two gathers for all columns."""
    i = idx[..., None, None].expand(*idx.shape, tab.shape[-2], 1)
    return (torch.gather(tab, -1, i).squeeze(-1),
            torch.gather(tab, -1, i + 1).squeeze(-1))


def _uinterp(utab, lo, step, x, cols, umin):
    """Stretched-grid linear interpolation with ``r_interpol`` edge rules:
    above range the last segment extrapolates, below range the column
    minimum.  ``utab`` [..., n_ucols, nel_u], ``umin`` [..., n_ucols].
    The two bracket entries of every column are gathered at once; the JAX
    package's one-hot pass sums the same two products and zeros (the
    tables are finite)."""
    idx, w = _ugrid_bracket(lo, step, x, utab.shape[-1])
    v1, v2 = _bracket_rows(utab, idx)
    w = w[..., None]
    v = torch.where((x < lo)[..., None], umin, (1.0 - w) * v1 + w * v2)
    return [v[..., c] for c in cols]


_UCOLS_SRC = (COL_CONV, COL_DKDA, COL_TOPW, COL_SKK)
# the table columns a Newton iteration of the exact path reads
_HOT_COLS = [COL_ELEV, COL_CONV, COL_DKDA, COL_TOPW]


def _resample_uniform(tab, nel_u: int):
    """Resample the hot columns of [r, C, n_cols, nel] exact tables onto
    sqrt-stretched uniform grids: (utab, lo, step, umin)."""
    el = tab[:, :, COL_ELEV, :].contiguous()          # [r, C, nel]
    nel = el.shape[-1]
    lo = el[..., 0]
    hi = el[..., -1]
    step = torch.sqrt(hi - lo) / (nel_u - 1)
    tgt = lo[..., None] + (step[..., None] * torch.arange(
        nel_u, dtype=tab.dtype, device=tab.device)) ** 2
    # the elevation grid is sorted, so the right search equals the JAX
    # package's compare-all count
    idx = torch.clamp(torch.searchsorted(el, tgt.contiguous(), right=True)
                      - 1, 0, nel - 2)                 # [r, C, nel_u]
    idx2 = torch.clamp_max(idx + 1, nel - 1)
    g1 = torch.gather(el, -1, idx)
    g2 = torch.gather(el, -1, idx2)
    w = (tgt - g1) / torch.where(g2 != g1, g2 - g1, 1.0)
    outs = []
    for c in _UCOLS_SRC:
        v = tab[:, :, c, :]
        v1 = torch.gather(v, -1, idx)
        v2 = torch.gather(v, -1, idx2)
        outs.append(v1 + (v2 - v1) * w)
    ut = torch.stack(outs, dim=-2)                     # [r, C, 4, nel_u]
    umin = torch.stack([tab[:, :, c, :].amin(-1) for c in _UCOLS_SRC], -1)
    return ut, lo, step, umin


def attach_uniform_tables(dom: DiffusiveDomain, nel_u: int = NEL_UNIFORM,
                          chunk: int = 256) -> DiffusiveDomain:
    """Resample the hot table columns onto per-node uniform elevation
    grids on the domain's device, ``chunk`` reaches at a time (the
    resampling's temporaries are [chunk, C, nel_u] per column)."""
    xs = dom.xsec
    batched = xs.dim() == 5
    if batched:
        b, r, c = xs.shape[:3]
        xs2 = xs.reshape(b * r, *xs.shape[2:])
    else:
        xs2 = xs
    parts = [_resample_uniform(xs2[s:s + chunk], int(nel_u))
             for s in range(0, xs2.shape[0], chunk)]
    utab, lo, step, umin = (torch.cat([p[k] for p in parts])
                            for k in range(4))
    if batched:
        utab = utab.reshape(b, r, c, len(_UCOLS_SRC), nel_u)
        lo, step = lo.reshape(b, r, c), step.reshape(b, r, c)
        umin = umin.reshape(b, r, c, len(_UCOLS_SRC))
    return dom._replace(utab=utab, ugrid_lo=lo, ugrid_step=step,
                        utab_min=umin)


def _table_interp(xsec, xcol, ycol, x):
    """Linear table interpolation per node: xsec [R, C, 11, nel], x [R, C]."""
    xarr = xsec[:, :, xcol, :]
    yarr = xsec[:, :, ycol, :]
    idx = torch.clamp(_count_le(xarr, x) - 1, 0, xarr.shape[-1] - 2)
    x1 = _fetch_last(xarr, idx)
    x2 = _fetch_last(xarr, idx + 1)
    y1 = _fetch_last(yarr, idx)
    y2 = _fetch_last(yarr, idx + 1)
    denom = torch.where(x2 != x1, x2 - x1, 1.0)
    return y1 + (y2 - y1) * (x - x1) / denom


def _hermite_coeffs(cour2, dxm):
    a1 = 3.0 * cour2 ** 2 - 2.0 * cour2 ** 3
    a2 = 1.0 - a1
    a3 = (cour2 ** 2 - cour2 ** 3) * dxm
    a4 = (-cour2 + 2.0 * cour2 ** 2 - cour2 ** 3) * dxm
    b1 = (6.0 * cour2 - 6.0 * cour2 ** 2) / (-dxm)
    b2 = -b1
    b3 = -(2.0 * cour2 - 3.0 * cour2 ** 2)
    b4 = -(-1.0 + 4.0 * cour2 - 3.0 * cour2 ** 2)
    dd1 = (6.0 - 12.0 * cour2) / dxm ** 2
    dd2 = -dd1
    dd3 = (2.0 - 6.0 * cour2) / dxm
    dd4 = (4.0 - 6.0 * cour2) / dxm
    h1 = 12.0 / dxm ** 3
    h2 = -h1
    h3 = 6.0 / dxm ** 2
    h4 = h3
    return (a1, a2, a3, a4), (b1, b2, b3, b4), (dd1, dd2, dd3, dd4), \
        (h1, h2, h3, h4)


def _forward_elim_coeffs(dom: DiffusiveDomain, st: DiffusiveState, dtini):
    """All CN-Hermite forward-elimination row coefficients in one [R, C-1]
    pass (slot j holds node column j+1), diffusive.f90:1164-1231."""
    dtini = _per_reach(dtini)
    oldQ, qpx = st.q, st.qpx
    dxm = dom.dx[:, :-1]
    cour = dtini / dxm
    cour2 = torch.abs(st.celerity[:, 1:]) * cour
    A, B, D, H = _hermite_coeffs(cour2, dxm)
    alpha = dom.dx[:, 1:] / dxm
    alpha = torch.cat([alpha[:, :-1], torch.ones_like(alpha[:, -1:])], 1)
    qL, qR = oldQ[:, :-1], oldQ[:, 1:]
    pL, pR = qpx[:, :-1], qpx[:, 1:]
    qy = A[0] * qL + A[1] * qR + A[2] * pL + A[3] * pR
    qxy = B[0] * qL + B[1] * qR + B[2] * pL + B[3] * pR
    qxxy = D[0] * qL + D[1] * qR + D[2] * pL + D[3] * pR
    qxxxy = H[0] * qL + H[1] * qR + H[2] * pL + H[3] * pR
    dif = st.diffusivity[:, 1:]
    ppi = -THETA * dif * dtini / dxm ** 2 \
        * 2.0 / (alpha * (alpha + 1.0)) * alpha
    qqi = 1.0 - ppi * (alpha + 1.0) / alpha
    rri = ppi / alpha
    ssi = qy + dtini * dif * (1.0 - THETA) * qxxy
    sxi = qxy + dtini * dif * (1.0 - THETA) * qxxxy
    return ppi, qqi, rri, ssi, sxi


def _doubling_scan(elems, combine, reverse=False):
    """Inclusive scan of tuples of [R, n] tensors along dim 1 by doubling
    (Hillis-Steele): log2(n) rounds, each combining every slot with the
    one ``d`` before it.  ``combine(earlier, later)``.  ``torch`` has no
    associative scan; the JAX package's ``lax.associative_scan`` pairs the
    same maps in another order, so the two agree to rounding."""
    if reverse:
        elems = tuple(torch.flip(e, (1,)) for e in elems)
    n = elems[0].shape[1]
    d = 1
    while d < n:
        new = combine(tuple(e[:, :-d] for e in elems),
                      tuple(e[:, d:] for e in elems))
        elems = tuple(torch.cat([e[:, :d], v], 1)
                      for e, v in zip(elems, new))
        d *= 2
    if reverse:
        elems = tuple(torch.flip(e, (1,)) for e in elems)
    return elems


def _linear_scan(a, b, init, reverse=False):
    """First-order linear recurrence along dim 1: forward ``v_j = a_j
    v_{j-1} + b_j`` from ``init`` before slot 0, reverse ``v_j = a_j
    v_{j+1} + b_j`` from ``init`` past the last slot; by doubling."""
    def combine(x, y):
        xa, xb = x
        ya, yb = y
        return ya * xa, ya * xb + yb

    ca, cb = _doubling_scan((a, b), combine, reverse=reverse)
    if init.dim() == 1:
        init = init[:, None]
    return ca * init + cb


def _forward_elim_assoc(dom: DiffusiveDomain, st: DiffusiveState, dtini):
    """eei/ffi/exi/fxi [R, C] by doubling scans (O(log C) rounds), the
    sequential recurrences re-associated: the eei/exi recurrences are
    Möbius maps composed as 2x2 transforms on (num, den), normalised per
    compose; given them, ffi/fxi are first-order linear scans.  Padding
    columns left of a reach's head are identity transforms, its head the
    reset (``troute_tpu/diffusive/solver.py:397-480``)."""
    R, C = dom.n_reaches, dom.n_cols
    ppi, qqi, rri, ssi, sxi = _forward_elim_coeffs(dom, st, dtini)
    cols = torch.arange(1, C, device=ppi.device)[None, :]
    is_head = dom.head_col[:, None] == cols
    is_pad = cols < dom.head_col[:, None]
    zero = torch.zeros_like(ppi)
    one = torch.ones_like(ppi)
    dead = is_pad | is_head

    def combine(a, b):
        a00, a01, a10, a11 = a
        b00, b01, b10, b11 = b
        c00 = b00 * a00 + b01 * a10
        c01 = b00 * a01 + b01 * a11
        c10 = b10 * a00 + b11 * a10
        c11 = b10 * a01 + b11 * a11
        s = torch.maximum(torch.maximum(torch.abs(c00), torch.abs(c01)),
                          torch.maximum(torch.abs(c10), torch.abs(c11)))
        s = torch.where(s > 0.0, s, 1.0)
        return c00 / s, c01 / s, c10 / s, c11 / s

    def mobius_vals(init_val):
        elems = (torch.where(is_pad, one, zero),
                 torch.where(dead, torch.where(is_pad, zero, init_val),
                             -rri),
                 torch.where(dead, zero, ppi),
                 torch.where(dead, one, qqi))
        c00, c01, c10, c11 = _doubling_scan(elems, combine)
        num = c00 * init_val + c01
        den = c10 * init_val + c11
        den = torch.where(torch.abs(den) > 1e-30, den, 1e-30)
        return num / den

    eei_v = mobius_vals(1.0)
    exi_v = mobius_vals(0.0)
    ones_col = torch.ones_like(ppi[:, :1])
    zeros_col = torch.zeros_like(ppi[:, :1])
    eei_prev = torch.cat([ones_col, eei_v[:, :-1]], 1)
    exi_prev = torch.cat([zeros_col, exi_v[:, :-1]], 1)
    den1 = ppi * eei_prev + qqi
    den2 = ppi * exi_prev + qqi
    den1 = torch.where(torch.abs(den1) > 1e-30, den1, 1e-30)
    den2 = torch.where(torch.abs(den2) > 1e-30, den2, 1e-30)
    af = torch.where(dead, zero, -ppi / den1)
    bf = torch.where(dead, zero, ssi / den1)
    ax = torch.where(dead, zero, -ppi / den2)
    bx = torch.where(dead, zero, sxi / den2)
    zr = zeros_col[:, 0]
    ffi_v = _linear_scan(af, bf, zr)
    fxi_v = _linear_scan(ax, bx, zr)
    return (torch.cat([ones_col, eei_v], 1), torch.cat([zeros_col, ffi_v], 1),
            torch.cat([zeros_col, exi_v], 1), torch.cat([zeros_col, fxi_v], 1))


def predictor_seq(dom: DiffusiveDomain, st: DiffusiveState, dtini, t):
    """One forward (discharge) step for all reaches, sequential form: C
    column steps of forward elimination and C of back substitution, the
    direct vectorisation of the reference per-node loops; returns (qp,
    qpx_new)."""
    R, C = dom.n_reaches, dom.n_cols
    oldQ, qpx = st.q, st.qpx
    eei_p = torch.ones_like(oldQ[:, 0])
    ffi_p = exi_p = fxi_p = torch.zeros_like(oldQ[:, 0])
    rows = [(eei_p, ffi_p, exi_p, fxi_p)]
    for i in range(1, C):
        dxm = dom.dx[:, i - 1]
        cour = dtini / dxm
        cour2 = torch.abs(st.celerity[:, i]) * cour
        A, B, D, H = _hermite_coeffs(cour2, dxm)
        alpha = (torch.ones_like(dxm) if i == C - 1
                 else dom.dx[:, i] / dxm)
        qy = A[0] * oldQ[:, i - 1] + A[1] * oldQ[:, i] \
            + A[2] * qpx[:, i - 1] + A[3] * qpx[:, i]
        qxy = B[0] * oldQ[:, i - 1] + B[1] * oldQ[:, i] \
            + B[2] * qpx[:, i - 1] + B[3] * qpx[:, i]
        qxxy = D[0] * oldQ[:, i - 1] + D[1] * oldQ[:, i] \
            + D[2] * qpx[:, i - 1] + D[3] * qpx[:, i]
        qxxxy = H[0] * oldQ[:, i - 1] + H[1] * oldQ[:, i] \
            + H[2] * qpx[:, i - 1] + H[3] * qpx[:, i]
        ppi = -THETA * st.diffusivity[:, i] * dtini / dxm ** 2 \
            * 2.0 / (alpha * (alpha + 1.0)) * alpha
        qqi = 1.0 - ppi * (alpha + 1.0) / alpha
        rri = ppi / alpha
        ssi = qy + dtini * st.diffusivity[:, i] * (1.0 - THETA) * qxxy
        sxi = qxy + dtini * st.diffusivity[:, i] * (1.0 - THETA) * qxxxy
        den1 = ppi * eei_p + qqi
        den2 = ppi * exi_p + qqi
        den1 = torch.where(torch.abs(den1) > 1e-30, den1, 1e-30)
        den2 = torch.where(torch.abs(den2) > 1e-30, den2, 1e-30)
        eei = -rri / den1
        ffi = (ssi - ppi * ffi_p) / den1
        exi = -rri / den2
        fxi = (sxi - ppi * fxi_p) / den2
        # at each reach's head column the recurrence (re)starts
        is_head = dom.head_col == i
        eei_p = torch.where(is_head, 1.0, eei)
        ffi_p = torch.where(is_head, 0.0, ffi)
        exi_p = torch.where(is_head, 0.0, exi)
        fxi_p = torch.where(is_head, 0.0, fxi)
        rows.append((eei_p, ffi_p, exi_p, fxi_p))
    eei, ffi, exi, fxi = (torch.stack([r[k] for r in rows], 1)
                          for k in range(4))
    return _predictor_tail(dom, st, dtini, t, eei, ffi, exi, fxi,
                           assoc=False)


def _predictor_tail(dom: DiffusiveDomain, st: DiffusiveState, dtini, t,
                    eei, ffi, exi, fxi, assoc: bool):
    """Ghost node, back substitution and junction hand-off, shared by both
    predictor forms (diffusive.f90:1233-1330)."""
    R, C = dom.n_reaches, dom.n_cols
    oldQ = st.q
    i = C - 1
    # the JAX package also evaluates the ghost row's own coefficients
    # (troute_tpu/diffusive/solver.py:566-593); nothing reads them
    qp_ghost = oldQ[:, i - 1]
    qpx_ghost = torch.zeros_like(qp_ghost)
    qp_last = eei[:, i] * qp_ghost + ffi[:, i]
    qpx_last = exi[:, i] * qpx_ghost + fxi[:, i]

    if assoc:
        qp_body = _linear_scan(eei[:, :C - 1], ffi[:, :C - 1], qp_last,
                               reverse=True)
        qpx_body = _linear_scan(exi[:, :C - 1], fxi[:, :C - 1], qpx_last,
                                reverse=True)
        qp = torch.cat([qp_body, qp_last[:, None]], 1)
        qpx_new = torch.cat([qpx_body, qpx_last[:, None]], 1)
    else:
        qps, qpxs = [qp_last], [qpx_last]
        for j in range(C - 2, -1, -1):
            qps.append(eei[:, j] * qps[-1] + ffi[:, j])
            qpxs.append(exi[:, j] * qpxs[-1] + fxi[:, j])
        qp = torch.stack(qps[::-1], 1)
        qpx_new = torch.stack(qpxs[::-1], 1)

    # junction hand-off: head inflow = the upstream reaches' bottom
    # discharges of this step (clamped at q_llm first, diffusive.f90:
    # 1321-1330) + the tributary series + the reach's lateral flow
    up = dom.up_reaches
    bottoms = qp[:, C - 1]
    bottoms = torch.where(torch.abs(bottoms) < Q_LLM, Q_LLM, bottoms)
    q_usrch = torch.where(up >= 0, bottoms[torch.clamp_min(up, 0)],
                          0.0).sum(dim=1)
    tf0 = t + dtini
    q_trib = _interp_series(dom.trib_q, dom.dt_trib, tf0)
    ql_now = _interp_series(dom.qlat, dom.dt_qlat, t)
    colv = torch.arange(C, device=qp.device)[None, :]
    interior = dom.valid & (colv > dom.head_col[:, None]) & (colv < C - 1)
    allqlat = torch.where(interior, ql_now * dom.dx, 0.0).sum(dim=1)
    rr = torch.arange(R, device=qp.device)
    head_ql = ql_now[rr, dom.head_col] * dom.dx[rr, dom.head_col]
    new_head_q = q_usrch + q_trib + head_ql + allqlat
    qp = qp.index_put((rr, dom.head_col), new_head_q)
    qp = torch.where(torch.abs(qp) < Q_LLM, Q_LLM, qp)
    return qp, qpx_new


def predictor(dom: DiffusiveDomain, st: DiffusiveState, dtini, t,
              form: str | None = None):
    """One forward (discharge) step for all reaches: (qp, qpx_new).
    ``form`` "assoc" (doubling scans) or "seq" (``predictor_seq``); None
    reads ``TROUTE_DIFF_PREDICTOR``, else ``PREDICTOR_DEFAULT``."""
    form = form or os.environ.get(PREDICTOR_ENV, PREDICTOR_DEFAULT)
    if form == "seq":
        return predictor_seq(dom, st, dtini, t)
    if form != "assoc":
        raise ValueError(f"unknown predictor form {form!r}")
    eei, ffi, exi, fxi = _forward_elim_assoc(dom, st, dtini)
    return _predictor_tail(dom, st, dtini, t, eei, ffi, exi, fxi,
                           assoc=True)


def _rtsafe_vec(xsec, rr, cur_col, ds_col, y_ds_elev, q_cur, q_ds, z_cur,
                z_ds, dx_cur, y_old_depth, active=None, grids=None,
                ugrids=None, y_norm=None, stats=None):
    """Vectorised Newton/bisection depth solve (reference
    ``rtsafe``/``funcd_diffdepth``, diffusive.f90:1568-1711); arguments as
    in ``troute_tpu/diffusive/solver.py:_rtsafe_vec``.  Lanes not
    ``active`` start converged.  Up to 40 iterations; the host reads
    whether all lanes have converged before each iteration."""
    def tab(grid, ycol_vals, x):
        """Interpolation of a column against ``grid`` [lanes, nel]; the
        column's values come from ``ycol_vals(idx)``."""
        idx = torch.clamp(_search_right(grid, x) - 1, 0, grid.shape[-1] - 2)
        x1 = _fetch_last(grid, idx)
        x2 = _fetch_last(grid, idx + 1)
        y1, y2 = ycol_vals(idx)
        den = torch.where(x2 != x1, x2 - x1, 1.0)
        return y1 + (y2 - y1) * (x - x1) / den

    def entries(col_of, c):
        """Column c of the table at ``col_of``: ``xsec`` entries."""
        return lambda idx: (xsec[rr, col_of, c, idx],
                            xsec[rr, col_of, c, idx + 1])

    y_ds = torch.clamp_min(y_ds_elev - z_ds, 0.005)
    slope = torch.clamp_min((z_cur - z_ds) / dx_cur, SO_LLM)
    aq_cur = torch.abs(q_cur) * q_cur
    slope_dx = slope * dx_cur

    if ugrids is not None:
        (ulo, ustep, ucur, umin_cur, ulo_ds, ustep_ds, uconv_ds,
         uconv_min_ds) = ugrids
        conv_ds = _uinterp(uconv_ds[:, None, :], ulo_ds, ustep_ds,
                           y_ds + z_ds, (0,), uconv_min_ds[:, None])[0]
        el_grid = hot = None
    else:
        if grids is not None:
            el_ds_grid, conv_ds_grid = grids[1], grids[6]
            conv_ds = tab(el_ds_grid, lambda idx: (
                _fetch_last(conv_ds_grid, idx),
                _fetch_last(conv_ds_grid, idx + 1)), y_ds + z_ds)
            el_grid, hot = grids[0], grids[3]
        else:
            conv_ds = tab(xsec[rr, ds_col, COL_ELEV, :],
                          entries(ds_col, COL_CONV), y_ds + z_ds)
            # the lanes' elevation grids, and the columns each Newton
            # iteration reads, gathered once per call
            el_grid = xsec[rr, cur_col, COL_ELEV, :]
            hot = xsec[rr, cur_col][:, _HOT_COLS, :]
    sf_ds = torch.abs(q_ds) * q_ds / torch.clamp_min(conv_ds, 1e-12) ** 2

    def f_df(y_cur):
        """Diffusive-momentum residual and derivative: one search of the
        elevation grid and two gathers serve conveyance, dK/dA and top
        width."""
        elv = y_cur + z_cur
        if ugrids is not None:
            conv, dkda, topw = _uinterp(
                ucur, ulo, ustep, elv, (UCOL_CONV, UCOL_DKDA, UCOL_TOPW),
                umin_cur)
            conv = torch.clamp_min(conv, 1e-12)
        else:
            idx = torch.clamp(_search_right(el_grid, elv) - 1, 0,
                              el_grid.shape[-1] - 2)
            v1, v2 = _bracket_rows(hot, idx)
            x1, x2 = v1[:, 0], v2[:, 0]
            w = (elv - x1) / torch.where(x2 != x1, x2 - x1, 1.0)
            vals = v1[:, 1:] + (v2[:, 1:] - v1[:, 1:]) * w[:, None]
            conv = torch.clamp_min(vals[:, 0], 1e-12)
            dkda, topw = vals[:, 1], vals[:, 2]
        sf_cur = aq_cur / conv ** 2
        f = y_cur - y_ds + slope_dx - 0.5 * (sf_cur + sf_ds) * dx_cur
        df = 1.0 + (aq_cur / conv ** 3) * dx_cur * topw * dkda
        return f, df

    if y_norm is None:
        elv_norm = tab(xsec[rr, cur_col, COL_UNIFORM, :],
                       entries(cur_col, COL_ELEV), torch.abs(q_cur))
        y_norm = elv_norm - z_cur
    x1 = 0.5 * (y_norm + y_old_depth) * 0.1
    x2 = 0.5 * (y_norm + y_old_depth) * 2.0

    fl, _ = f_df(x1)
    fh, _ = f_df(x2)
    no_bracket = ((fl > 0) & (fh > 0)) | ((fl < 0) & (fh < 0))
    xl = torch.where(fl < 0, x1, x2)
    xh = torch.where(fl < 0, x2, x1)
    root = 0.5 * (x1 + x2)
    dxold = torch.abs(x2 - x1)
    dxx = dxold
    f, df = f_df(root)
    done = (torch.zeros_like(root, dtype=torch.bool) if active is None
            else ~active)
    _count(stats, "rtsafe_calls")
    # the loop state, updated by one select per iteration
    state = torch.stack([root, xl, xh, dxold, dxx, f, df])
    for _ in range(RTSAFE_MAX_ITERS):
        # one host read per iteration: an iteration costs tens of launches,
        # a read a few of them
        _count(stats, "syncs")
        if bool(done.all()):
            break
        _count(stats, "newton_iters")
        root, xl, xh, dxold, dxx, f, df = state.unbind(0)
        use_bisect = (((root - xh) * df - f) * ((root - xl) * df - f)
                      > 0.0) | (torch.abs(2.0 * f) > torch.abs(dxold * df))
        dxx_bis = 0.5 * (xh - xl)
        root_bis = xl + dxx_bis
        dxx_newt = f / torch.where(df != 0.0, df, 1.0)
        root_newt = root - dxx_newt
        root_n = torch.where(use_bisect, root_bis, root_newt)
        dxx_n = torch.where(use_bisect, dxx_bis, dxx_newt)
        stalled = torch.where(use_bisect, xl == root_n, root == root_n)
        conv_now = torch.abs(dxx_n) < 1e-4
        f_n, df_n = f_df(root_n)
        below = f_n < 0
        new = torch.stack([root_n, torch.where(below, root_n, xl),
                           torch.where(below, xh, root_n), dxx, dxx_n, f_n,
                           df_n])
        state = torch.where(done, state, new)
        done = done | stalled | conv_now
    root = state[0]
    # unconverged or unbracketed -> normal depth (reference fallback)
    root = torch.where(no_bracket | ~done, y_norm, root)
    root = torch.where(fl == 0.0, x1, root)
    root = torch.where(fh == 0.0, x2, root)
    return root


def _col_interp(xs_col, z_col, xcol, ycol, x, squared=False):
    """Per-node table interpolation: xs_col [R, 11, nel], x [R];
    ``squared`` interpolates against squared depth (diffusive.f90:1437)."""
    if squared:
        xarr = (xs_col[:, COL_ELEV, :] - z_col[:, None]) ** 2
        x = (x - z_col) ** 2
    else:
        xarr = xs_col[:, xcol, :]
    yarr = xs_col[:, ycol, :]
    idx = torch.clamp(_count_le(xarr, x) - 1, 0, xarr.shape[-1] - 2)
    x1 = _fetch_last(xarr, idx)
    x2 = _fetch_last(xarr, idx + 1)
    y1 = _fetch_last(yarr, idx)
    y2 = _fetch_last(yarr, idx + 1)
    den = torch.where(x2 != x1, x2 - x1, 1.0)
    return y1 + (y2 - y1) * (x - x1) / den


MINDEPTH_NSTAB = 0.1    # diffusive.f90:264


def _tailwater_elevation(dom: DiffusiveDomain, qp, t_next, signed_q=False):
    """[R] bottom-boundary elevation per reach: the coastal depth series
    where present (time-interpolated like ``intp_y``), normal depth
    otherwise; ``signed_q`` is the initialization lookup's signed
    discharge (diffusive.f90:554).  ``t_next`` 0-d or [R]."""
    C = dom.n_cols
    q_bot = qp[:, C - 1] if signed_q else torch.abs(qp[:, C - 1])
    elv_norm_bot = _col_interp(dom.xsec[:, C - 1], dom.z[:, C - 1],
                               COL_UNIFORM, COL_ELEV, q_bot)
    if dom.db_depth is None:
        return elv_norm_bot
    dtype = qp.dtype
    n_db = dom.db_depth.shape[1]
    tarr = torch.arange(n_db, dtype=dtype, device=qp.device) * dom.dt_db
    t_next = torch.as_tensor(t_next, dtype=dtype, device=qp.device)
    i0 = torch.clamp(torch.searchsorted(tarr, t_next.reshape(-1),
                                        right=True) - 1,
                     0, max(n_db - 2, 0))
    i1 = torch.clamp_max(i0 + 1, n_db - 1)
    t1, t2 = tarr[i0], tarr[i1]
    w = torch.where(t2 != t1, (t_next.reshape(-1) - t1)
                    / torch.where(t2 != t1, t2 - t1, 1.0), 0.0)
    if t_next.dim() == 0:
        depth_db = dom.db_depth[:, i0[0]] * (1.0 - w) \
            + dom.db_depth[:, i1[0]] * w
    else:
        rows = torch.arange(dom.db_depth.shape[0], device=qp.device)
        depth_db = dom.db_depth[rows, i0] * (1.0 - w) \
            + dom.db_depth[rows, i1] * w
    z_bot = dom.z[:, C - 1]
    y_coastal = torch.maximum(depth_db + z_bot, MINDEPTH_NSTAB + z_bot)
    return torch.where(torch.isfinite(depth_db), y_coastal, elv_norm_bot)


def _reach_means(dom: DiffusiveDomain, cel2, dif2):
    """Reach-average celerity and diffusivity (diffusive.f90:1540-1551),
    broadcast over the reach's columns."""
    R, C = dom.n_reaches, dom.n_cols
    nvalid = torch.clamp_min(dom.valid.sum(dim=1), 1)
    cel_mean = torch.where(dom.valid, cel2, 0.0).sum(dim=1) / nvalid
    dif_mean = torch.where(dom.valid, dif2, 0.0).sum(dim=1) / nvalid
    cel_mean = torch.clamp_min(cel_mean, C_LLM)
    dif_mean = torch.clamp(dif_mean, D_LLM, D_ULM)
    return (cel_mean[:, None].expand(R, C), dif_mean[:, None].expand(R, C))


def corrector(dom: DiffusiveDomain, st: DiffusiveState, qp, dtini_min,
              t_next=0.0, init_mode=False, group=None, n_groups=1,
              stats=None):
    """Depth/WSE sweep over the global node wavefront (``dom.bwd_active``
    / ``bwd_col``): one step per node along the longest downstream node
    path, all reaches' nodes of a step at once, each solved by
    ``_rtsafe_vec``.  ``init_mode`` is the reference initialization sweep
    (diffusive.f90:563-571).  Returns (newY, celerity, diffusivity).
    ``group``/``n_groups`` go unused: a fixed schedule has no
    convergence test to split by domain."""
    R, C = dom.n_reaches, dom.n_cols
    dev = qp.device
    rr = torch.arange(R, device=dev)
    oldY = st.y
    y_tw_const = _tailwater_elevation(dom, qp, t_next, signed_q=init_mode)
    xmin = (dom.xsec_min if dom.xsec_min is not None
            else dom.xsec.amin(-1))
    ds = dom.ds_reach
    ds_safe = torch.clamp_min(ds, 0)
    ds_head_col = dom.head_col[ds_safe]
    nel = dom.xsec.shape[-1]
    newY = st.y
    cel2 = torch.zeros_like(qp)
    dif2 = torch.zeros_like(qp)
    wdepth = torch.zeros_like(qp[:, 0])
    for active, col in zip(dom.bwd_active, dom.bwd_col):
        safe = torch.clamp(col, 0, C - 1)
        y_junc = newY[ds_safe, ds_head_col]
        y_bot = torch.where(ds >= 0, y_junc, y_tw_const)
        entering = active & (safe == C - 1)
        newY = torch.cat([newY[:, :C - 1], torch.where(
            entering, y_bot, newY[:, C - 1])[:, None]], 1)
        wdepth = torch.where(entering, y_bot - dom.z[:, C - 1], wdepth)

        z_i = dom.z[rr, safe]
        y_i = newY[rr, safe]
        q_i = qp[rr, safe]
        el_i = dom.xsec[rr, safe, COL_ELEV, :]           # [R, nel]
        xmin_i = xmin[rr, safe]                          # [R, 11]

        def interp_at(grid, x, c):
            """r_interpol semantics (diffusive.f90:2553-2594)."""
            idx = torch.clamp(_search_right(grid, x) - 1, 0, nel - 2)
            g1 = _fetch_last(grid, idx)
            g2 = _fetch_last(grid, idx + 1)
            w = (x - g1) / torch.where(g2 != g1, g2 - g1, 1.0)
            v1 = dom.xsec[rr, safe, c, idx]
            v2 = dom.xsec[rr, safe, c, idx + 1]
            return torch.where(x < grid[:, 0], xmin_i[:, c],
                               v1 + (v2 - v1) * w)

        d2_grid = (el_i - z_i[:, None]) ** 2
        co = torch.clamp_min(interp_at(d2_grid, (y_i - z_i) ** 2, COL_CONV),
                             1e-12)
        bo = torch.clamp_min(interp_at(el_i, y_i, COL_TOPW), 1e-12)
        sk = interp_at(el_i, y_i, COL_SKK)
        sfi = q_i * torch.abs(q_i) / co ** 2
        cel_i = (5.0 / 3.0) * torch.abs(sfi) ** 0.3 \
            * torch.abs(q_i) ** 0.4 / bo ** 0.4 \
            / (1.0 / torch.clamp_min(sk, 1e-12)) ** 0.6
        dx_ref = torch.where(safe > dom.head_col,
                             dom.dx[rr, torch.clamp_min(safe - 1, 0)],
                             dom.dx[rr, safe])
        cel_i = torch.minimum(cel_i, CFL * dx_ref / dtini_min)
        dif_i = torch.abs(q_i) / 2.0 / bo / torch.clamp_min(torch.abs(sfi),
                                                            1e-12)
        cel2 = cel2.index_put((rr, safe), torch.where(active, cel_i,
                                                      cel2[rr, safe]))
        dif2 = dif2.index_put((rr, safe), torch.where(active, dif_i,
                                                      dif2[rr, safe]))

        up_col = torch.clamp_min(safe - 1, 0)
        solve_mask = active & (safe > 0) & (safe - 1 >= dom.head_col)
        y_old_depth = (wdepth if init_mode
                       else oldY[rr, up_col] - dom.z[rr, up_col])
        y_up = _rtsafe_vec(
            dom.xsec, rr, up_col, safe, y_i, qp[rr, up_col], q_i,
            dom.z[rr, up_col], z_i, dom.dx[rr, up_col], y_old_depth,
            active=solve_mask, stats=stats)
        elev_up = torch.clamp_max(y_up + dom.z[rr, up_col], 1.0e5)
        newY = newY.index_put((rr, up_col), torch.where(
            solve_mask, elev_up, newY[rr, up_col]))
    return (newY,) + _reach_means(dom, cel2, dif2)


def _group_max(v, group, n_groups):
    """Max of [R] per-reach values over each domain: [n_groups], or 0-d
    for one domain (``group`` None)."""
    if group is None:
        return v.max()
    out = torch.full((n_groups,), -torch.inf, dtype=v.dtype, device=v.device)
    return out.scatter_reduce(0, group, v, reduce="amax")


def corrector_jacobi(dom: DiffusiveDomain, st: DiffusiveState, qp,
                     dtini_min, t_next=0.0, tol=1e-6, init_mode=False,
                     group=None, n_groups=1, stats=None):
    """Fixed-point (Jacobi) form of the depth sweep: every interior node
    solves its ``rtsafe`` relation against the previous iterate's
    downstream value, all nodes at once, until the iterate moves less
    than max(tol, 4 eps max |y|) or D + 2 sweeps; with uniform tables each
    sweep is Gauss-Seidel within a reach (columns C-2 .. 0) and Jacobi
    across junctions (``troute_tpu/diffusive/solver.py:1030-1329``).  The
    host reads each sweep's delta and max |y|: the JAX while loop tests
    them after every sweep, and an extra sweep moves y.  With ``group``,
    each domain stops on its own delta and then holds its surface."""
    R, C = dom.n_reaches, dom.n_cols
    dev, dtype = qp.device, qp.dtype
    real = torch.empty(0, dtype=dtype).numpy().dtype.type
    y_tw_const = _tailwater_elevation(dom, qp, t_next, signed_q=init_mode)
    P = R * (C - 1)

    def cur(a):
        return a[:, :C - 1].reshape((P,) + a.shape[2:]).contiguous()

    def dsv(a):
        return a[:, 1:].reshape((P,) + a.shape[2:]).contiguous()

    rrf = torch.arange(R, device=dev).repeat_interleave(C - 1)
    curf = torch.arange(C - 1, device=dev).repeat(R)
    dsf = curf + 1
    interior = (torch.arange(C - 1, device=dev)[None, :]
                >= dom.head_col[:, None]).reshape(P)
    ds = dom.ds_reach
    ds_safe = torch.clamp_min(ds, 0)
    ds_head_col = dom.head_col[ds_safe]
    z_cur, z_ds = cur(dom.z), dsv(dom.z)
    q_cur, q_ds = cur(qp), dsv(qp)
    dx_cur = cur(dom.dx)
    y_old_depth = cur(st.y) - z_cur
    max_sweeps = int(dom.bwd_active.shape[0]) + 2
    xs_elev = dom.xsec[:, :, COL_ELEV, :]
    if dom.utab is not None:
        grids = (cur(xs_elev), None, cur(dom.xsec[:, :, COL_UNIFORM, :]))
        ugrids = (cur(dom.ugrid_lo), cur(dom.ugrid_step), cur(dom.utab),
                  cur(dom.utab_min), dsv(dom.ugrid_lo), dsv(dom.ugrid_step),
                  dsv(dom.utab[:, :, UCOL_CONV, :]),
                  dsv(dom.utab_min[:, :, UCOL_CONV]))
    else:
        grids = (cur(xs_elev), dsv(xs_elev),
                 cur(dom.xsec[:, :, COL_UNIFORM, :]),
                 cur(dom.xsec[:, :, _HOT_COLS, :]), None, None,
                 dsv(dom.xsec[:, :, COL_CONV, :]))
        ugrids = None

    # normal depth per node, once per call: it depends on qp and the
    # tables only
    uni_g, el_g = grids[2], grids[0]
    q_abs = torch.abs(q_cur)
    n_idx = torch.clamp(_search_right(uni_g, q_abs) - 1, 0,
                        uni_g.shape[-1] - 2)
    nx1 = _fetch_last(uni_g, n_idx)
    nx2 = _fetch_last(uni_g, n_idx + 1)
    ny1 = _fetch_last(el_g, n_idx)
    ny2 = _fetch_last(el_g, n_idx + 1)
    elv_norm_flat = ny1 + (ny2 - ny1) * (q_abs - nx1) \
        / torch.where(nx2 != nx1, nx2 - nx1, 1.0)
    y_norm_flat = elv_norm_flat - z_cur
    y_norm_cols = y_norm_flat.reshape(R, C - 1)

    def bottom(y):
        y_junc = y[ds_safe, ds_head_col]
        return torch.where(ds >= 0, y_junc, y_tw_const)

    def sweep(y):
        y_bot = bottom(y)
        y1 = torch.cat([y[:, :C - 1], y_bot[:, None]], 1)
        if init_mode:
            y_old = (y_bot - dom.z[:, C - 1]).repeat_interleave(C - 1)
        else:
            y_old = y_old_depth
        y_up = _rtsafe_vec(
            dom.xsec, rrf, curf, dsf, dsv(y1), q_cur, q_ds, z_cur, z_ds,
            dx_cur, y_old, active=interior, grids=grids, ugrids=ugrids,
            y_norm=y_norm_flat, stats=stats)
        elev_up = torch.clamp_max(y_up + z_cur, 1.0e5)
        new_vals = torch.where(interior, elev_up, cur(y1))
        return torch.cat([new_vals.reshape(R, C - 1), y1[:, -1:]], 1)

    def pick(a, i):
        return a.reshape(R, C - 1, *a.shape[1:])[:, i].contiguous()

    # each column's tables, laid out once per call for the GS sweeps
    col_tabs = ([] if ugrids is None else
                [([pick(u, i) for u in ugrids],
                  (pick(grids[0], i), None, pick(grids[2], i)))
                 for i in range(C - 1)])

    def sweep_gs(y):
        y_bot = bottom(y)
        cols = [y[:, i] for i in range(C - 1)] + [y_bot]
        for i in range(C - 2, -1, -1):
            active_i = i >= dom.head_col
            if init_mode:
                y_old_i = y_bot - dom.z[:, C - 1]
            else:
                y_old_i = torch.clamp_min(cols[i] - dom.z[:, i], 0.005)
            col_ugrids, col_grids = col_tabs[i]
            y_up = _rtsafe_vec(
                dom.xsec, rrf[:R], curf[:R], dsf[:R], cols[i + 1], qp[:, i],
                qp[:, i + 1], dom.z[:, i], dom.z[:, i + 1], dom.dx[:, i],
                y_old_i, active=active_i, grids=col_grids,
                ugrids=col_ugrids, y_norm=y_norm_cols[:, i], stats=stats)
            elev_i = torch.clamp_max(y_up + dom.z[:, i], 1.0e5)
            cols[i] = torch.where(active_i, elev_i, cols[i])
        return torch.stack(cols, 1)

    step = sweep_gs if ugrids is not None else sweep
    eps4 = real(4.0) * real(torch.finfo(dtype).eps)
    tol_d = real(tol)
    n_g = 1 if group is None else n_groups
    delta = [real(np.inf)] * n_g
    ymax = [real(0.0)] * n_g
    y = st.y
    k = 0
    while True:
        run = [k < max_sweeps and delta[g] > max(tol_d, eps4 * ymax[g])
               for g in range(n_g)]
        if not any(run):
            break
        y2 = step(y)
        d_r = torch.where(dom.valid, torch.abs(y2 - y), 0.0).amax(dim=1)
        m_r = torch.where(dom.valid, torch.abs(y2), 0.0).amax(dim=1)
        both = torch.stack([_group_max(d_r, group, n_groups),
                            _group_max(m_r, group, n_groups)])
        if group is None:
            y = y2
        else:
            run_t = torch.as_tensor(run, device=dev)
            y = torch.where(run_t[group][:, None], y2, y)
        # the sweep's one read on the host
        _count(stats, "syncs")
        both = both.reshape(2, -1).cpu().numpy()
        for g in range(n_g):
            if run[g]:
                delta[g], ymax[g] = real(both[0, g]), real(both[1, g])
        k += 1
    if stats is not None:
        stats.setdefault("sweeps", []).append(k)
    newY = y

    # hydraulics at every valid node, then reach means
    z_a = dom.z.reshape(R * C)
    y_a = newY.reshape(R * C)
    q_a = qp.reshape(R * C)
    if dom.utab is not None:
        lo_a = dom.ugrid_lo.reshape(R * C)
        st_a = dom.ugrid_step.reshape(R * C)
        ut_a = dom.utab.reshape(R * C, *dom.utab.shape[2:])
        um_a = dom.utab_min.reshape(R * C, -1)
        bo, sk = _uinterp(ut_a, lo_a, st_a, y_a, (UCOL_TOPW, UCOL_SKK), um_a)
        bo = torch.clamp_min(bo, 1e-12)
        # conveyance against squared depth: the bracket from elevation,
        # the weight in d^2 space (linear inside the notch)
        nel_u = ut_a.shape[-1]
        idx, w_lin = _ugrid_bracket(lo_a, st_a, y_a, nel_u)
        fidx = idx.to(dtype)
        d1 = (lo_a - z_a) + (fidx * st_a) ** 2
        d2v = (lo_a - z_a) + ((fidx + 1.0) * st_a) ** 2
        den = d2v ** 2 - d1 ** 2
        depth = y_a - z_a
        w_sq = torch.where((d1 >= 0.0) & (den > 1e-30),
                           (depth ** 2 - d1 ** 2)
                           / torch.where(den > 1e-30, den, 1.0), w_lin)
        uconv = ut_a[:, UCOL_CONV, :]
        co = ((1.0 - w_sq) * _fetch_last(uconv, idx)
              + w_sq * _fetch_last(uconv, idx + 1))
        co = torch.where(y_a < lo_a, um_a[:, UCOL_CONV], co)
        co = torch.clamp_min(co, 1e-12)
    else:
        el_a = dom.xsec[:, :, COL_ELEV, :].reshape(R * C, -1).contiguous()
        nel = el_a.shape[-1]
        xmin = (dom.xsec_min if dom.xsec_min is not None
                else dom.xsec.amin(-1))
        xmin_a = xmin.reshape(R * C, -1)

        def interp_at(grid, x, c):
            idx = torch.clamp(_search_right(grid, x) - 1, 0, nel - 2)
            g1 = _fetch_last(grid, idx)
            g2 = _fetch_last(grid, idx + 1)
            w = (x - g1) / torch.where(g2 != g1, g2 - g1, 1.0)
            v = dom.xsec[:, :, c, :].reshape(R * C, -1)
            v1 = _fetch_last(v, idx)
            v2 = _fetch_last(v, torch.clamp_max(idx + 1, nel - 1))
            return torch.where(x < grid[:, 0], xmin_a[:, c],
                               v1 + (v2 - v1) * w)

        d2_grid = (el_a - z_a[:, None]) ** 2
        co = torch.clamp_min(interp_at(d2_grid, (y_a - z_a) ** 2, COL_CONV),
                             1e-12)
        bo = torch.clamp_min(interp_at(el_a, y_a, COL_TOPW), 1e-12)
        sk = interp_at(el_a, y_a, COL_SKK)
    sfi = q_a * torch.abs(q_a) / co ** 2
    cel_a = (5.0 / 3.0) * torch.abs(sfi) ** 0.3 \
        * torch.abs(q_a) ** 0.4 / bo ** 0.4 \
        / (1.0 / torch.clamp_min(sk, 1e-12)) ** 0.6
    col_a = torch.arange(C, device=dev).repeat(R)
    dx_prev = torch.cat([dom.dx[:, :1], dom.dx[:, :-1]], 1).reshape(R * C)
    dx_ref = torch.where(col_a > dom.head_col.repeat_interleave(C),
                         dx_prev, dom.dx.reshape(R * C))
    cel_a = torch.minimum(cel_a, CFL * dx_ref / dtini_min)
    dif_a = torch.abs(q_a) / 2.0 / bo / torch.clamp_min(torch.abs(sfi),
                                                        1e-12)
    return (newY,) + _reach_means(dom, cel_a.reshape(R, C),
                                  dif_a.reshape(R, C))


def _corrector_fn(corrector_mode: str):
    if corrector_mode == "jacobi":
        return corrector_jacobi
    if corrector_mode == "wavefront":
        return corrector
    raise ValueError(f"unknown corrector mode {corrector_mode!r}")


def _max_cel_dx(dom: DiffusiveDomain, celerity, group=None, n_groups=1):
    """max celerity/dx over valid interior nodes (at least 1e-12), for the
    next adaptive dt: 0-d, or [n_groups] per domain."""
    C = dom.n_cols
    colv = torch.arange(C, device=celerity.device)[None, :]
    interior = dom.valid & (colv < C - 1)
    per_reach = torch.where(interior, celerity / dom.dx, 0.0).amax(dim=1)
    return torch.clamp_min(_group_max(per_reach, group, n_groups), 1e-12)


def diffusive_step(dom: DiffusiveDomain, st: DiffusiveState, dtini,
                   dtini_min: float, corrector_mode: str = "wavefront",
                   predictor_form: str | None = None, group=None,
                   n_groups: int = 1, stats=None):
    """One internal CN timestep (predictor, corrector) and the max
    celerity/dx for the next adaptive dt.  ``dtini`` a 0-d tensor, or [R]
    per reach with ``group`` (then ``st.t`` is [R] too)."""
    qp, qpx_new = predictor(dom, st, dtini, st.t, form=predictor_form)
    newY, celerity, diffusivity = _corrector_fn(corrector_mode)(
        dom, st, qp, dtini_min, t_next=st.t + dtini, group=group,
        n_groups=n_groups, stats=stats)
    new_state = DiffusiveState(q=qp, y=newY, qpx=qpx_new, celerity=celerity,
                               diffusivity=diffusivity, t=st.t + dtini)
    return new_state, _max_cel_dx(dom, celerity, group, n_groups)


def initialize_state(dom: DiffusiveDomain, q_init, dtini_min: float,
                     corrector_mode: str = "wavefront", group=None,
                     n_groups: int = 1, stats=None):
    """Reference initialization (diffusive.f90:530-582): tailwater bottoms
    at normal depth (signed-q lookup) or the coastal series at t=0,
    junction hand-up, flat-depth ``rtsafe`` warm start, one backward
    sweep.  ``q_init`` is not clamped at q_llm (:362-364)."""
    R, C = dom.n_reaches, dom.n_cols
    q = torch.as_tensor(q_init, dtype=dom.z.dtype, device=dom.z.device)
    elv_norm = _table_interp(dom.xsec, COL_UNIFORM, COL_ELEV, torch.abs(q))
    st = DiffusiveState(
        q=q, y=elv_norm, qpx=torch.zeros_like(q),
        celerity=torch.ones_like(q), diffusivity=torch.full_like(q, 10.0),
        t=torch.zeros((), dtype=q.dtype, device=q.device))
    t0 = torch.zeros((), dtype=q.dtype, device=q.device)
    newY, celerity, diffusivity = _corrector_fn(corrector_mode)(
        dom, st, q, dtini_min, t_next=t0, init_mode=True, group=group,
        n_groups=n_groups, stats=stats)
    return st._replace(y=newY, celerity=celerity, diffusivity=diffusivity)


def _time_loop(dom: DiffusiveDomain, st: DiffusiveState, t_final: float,
               save_interval: float, corrector_mode: str, predictor_form,
               group, n_groups: int, on_save, stats):
    """The adaptive time loop of every run (reference ``calculateDT``),
    per domain: dt = CFL / max celerity/dx, cut to end on the next save
    boundary and on ``t_final``, at least 1e-3 s.  Times and timesteps are
    Python floats (the JAX package's host loop; in f64 its device loop
    computes the same values), and the state's clock advances by the
    timestep in the dtype.  The host reads max celerity/dx once per
    sub-step.  A finished domain holds its state.  ``on_save(g, t, st)``
    runs where domain g's clock lands on a save boundary (or reaches
    ``t_final``)."""
    dtype, dev = st.q.dtype, st.q.device
    n_g = 1 if group is None else n_groups
    interior0 = dom.valid & (torch.arange(dom.n_cols, device=dev)[None, :]
                             < dom.n_cols - 1)
    min_dx = torch.where(interior0, dom.dx, torch.inf).amin(dim=1)
    min_dx = (min_dx.min().reshape(1) if group is None
              else torch.full((n_g,), torch.inf, dtype=dtype,
                              device=dev).scatter_reduce(
                                  0, group, min_dx, reduce="amin"))
    mcd = [1.0 / float(v) for v in min_dx.cpu().numpy()]
    t = [float(v) for v in st.t.reshape(-1).cpu().numpy()]
    eps = 1e-6
    dtini_min = float(dom.dtini_given) / DTINI_DIVISOR
    while True:
        running = [t[g] < t_final - eps for g in range(n_g)]
        if not any(running):
            break
        dts = []
        for g in range(n_g):
            dtini = CFL / mcd[g]
            a = int(np.floor(t[g] / save_interval))
            b = int(np.floor((t[g] + dtini) / save_interval))
            if b > a:
                dtini = (a + 1) * save_interval - t[g]
            dtini = min(dtini, t_final - t[g])
            dts.append(max(dtini, 1e-3))
        if group is None:
            dt_t = torch.tensor(dts[0], dtype=dtype, device=dev)
            st_in = st
        else:
            dt_t = torch.tensor(dts, dtype=dtype, device=dev)[group]
            st_in = st._replace(t=st.t[group])
        new, mcd_t = diffusive_step(dom, st_in, dt_t, dtini_min,
                                    corrector_mode, predictor_form, group,
                                    n_groups, stats)
        _count(stats, "substeps")
        _count(stats, "syncs")
        mcd_h = mcd_t.reshape(-1).cpu().numpy()
        if group is None:
            st = new
        else:
            run_t = torch.as_tensor(running, device=dev)
            keep = run_t[group][:, None]
            st = DiffusiveState(
                *[torch.where(keep, a, b) for a, b in zip(new[:5], st[:5])],
                t=torch.where(run_t, st.t + torch.tensor(
                    dts, dtype=dtype, device=dev), st.t))
        for g in range(n_g):
            if not running[g]:
                continue
            mcd[g] = float(mcd_h[g])
            t[g] += dts[g]
            if abs(t[g] % save_interval) < 1e-6 or abs(
                    t[g] % save_interval - save_interval) < 1e-6 \
                    or t[g] >= t_final - eps:
                on_save(g, t[g], st)
    return st


def _save_slot(t: float, t_start: float, save_interval: float,
               n_saves: int) -> int | None:
    """The "device" save slot of clock ``t`` when it lies on a save
    boundary (slot k holds t_start + (k + 1) intervals), else None."""
    ratio = t / save_interval
    if abs(ratio - round(ratio)) >= 1e-6 / save_interval:
        return None
    k = int(round(ratio)) - 1 - int(round(t_start / save_interval))
    return min(max(k, 0), n_saves - 1)


def run_diffusive(dom: DiffusiveDomain, st: DiffusiveState, t_final: float,
                  save_interval: float, corrector_mode: str = "wavefront",
                  dispatch: str = "auto", predictor_form: str | None = None,
                  stats: dict | None = None):
    """Adaptive time loop; returns (final state, [(t, q, y), ...] saves).

    ``corrector_mode``: "wavefront" (node by node, reference parity) or
    "jacobi" (the fixed-point iteration).  ``dispatch`` keeps the JAX
    package's two forms of the saves over one loop: "host" appends a save
    wherever the clock lands on an interval boundary; "device" returns
    ``round((t_final - t_start) / save_interval)`` slots at the boundary
    times, slot k filled by the clock that rounds to it, and the last slot
    always the final state (``troute_tpu/diffusive/solver.py:1432``); an
    unfilled slot holds zeros.  "auto": "device" for CUDA tensors, "host"
    on the CPU.  ``stats`` (a dict) gathers 'substeps', 'sweeps' per
    corrector call, 'rtsafe_calls', 'newton_iters' and 'syncs' (host
    reads)."""
    if dispatch == "auto":
        dispatch = "device" if st.q.device.type == "cuda" else "host"
    if dispatch not in ("host", "device"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    t_start = float(st.t)
    saves = []
    if dispatch == "host":
        st = _time_loop(dom, st, t_final, save_interval, corrector_mode,
                        predictor_form, None, 1,
                        lambda g, t, s: saves.append((t, s.q, s.y)), stats)
        return st, saves
    n_saves = int(round((t_final - t_start) / save_interval))
    if n_saves <= 0:
        return st, []
    qs = torch.zeros((n_saves,) + tuple(st.q.shape), dtype=st.q.dtype,
                     device=st.q.device)
    ys = torch.zeros_like(qs)

    def on_save(g, t, s):
        k = _save_slot(t, t_start, save_interval, n_saves)
        if k is not None:
            qs[k], ys[k] = s.q, s.y

    st = _time_loop(dom, st, t_final, save_interval, corrector_mode,
                    predictor_form, None, 1, on_save, stats)
    qs[n_saves - 1], ys[n_saves - 1] = st.q, st.y
    return st, [(t_start + (k + 1) * save_interval, qs[k], ys[k])
                for k in range(n_saves)]


def _flatten(dom: DiffusiveDomain):
    """A batched [B, R, C] domain as one [B*R, C] domain (reach indices
    offset per domain) and each reach's domain index."""
    B, R = dom.z.shape[:2]
    dev = dom.z.device
    off = (torch.arange(B, device=dev) * R)[:, None]

    def shift(a):
        return torch.where(a >= 0, a + off.reshape((B,) + (1,) * (a.dim()
                                                                 - 1)), a)

    def rows(a):
        return None if a is None else a.reshape((B * R,) + a.shape[2:])

    flat = dom._replace(
        z=rows(dom.z), dx=rows(dom.dx), ncomp=rows(dom.ncomp),
        head_col=rows(dom.head_col), valid=rows(dom.valid),
        xsec=rows(dom.xsec), ds_reach=rows(shift(dom.ds_reach)),
        up_reaches=rows(shift(dom.up_reaches)),
        bwd_active=dom.bwd_active.permute(1, 0, 2).reshape(
            dom.bwd_active.shape[1], B * R),
        bwd_col=dom.bwd_col.permute(1, 0, 2).reshape(
            dom.bwd_col.shape[1], B * R),
        trib_q=dom.trib_q.permute(1, 0, 2).reshape(dom.trib_q.shape[1],
                                                   B * R),
        qlat=dom.qlat.permute(1, 0, 2, 3).reshape(
            dom.qlat.shape[1], B * R, dom.qlat.shape[-1]),
        db_depth=rows(dom.db_depth), xsec_min=rows(dom.xsec_min),
        utab=rows(dom.utab), ugrid_lo=rows(dom.ugrid_lo),
        ugrid_step=rows(dom.ugrid_step), utab_min=rows(dom.utab_min))
    group = torch.arange(B, device=dev).repeat_interleave(R)
    return flat, group


def _flat_state(st: DiffusiveState) -> DiffusiveState:
    B, R, C = st.q.shape
    return DiffusiveState(*[a.reshape(B * R, C) for a in st[:5]],
                          t=st.t.reshape(B))


def _batched_state(st: DiffusiveState, B: int) -> DiffusiveState:
    return DiffusiveState(*[a.reshape(B, -1, a.shape[-1]) for a in st[:5]],
                          t=st.t)


def initialize_state_batched(dom: DiffusiveDomain, q_init, dtini_min: float,
                             corrector_mode: str = "wavefront", stats=None):
    """``initialize_state`` of each domain of a batched [B, R, C] domain."""
    B = dom.z.shape[0]
    flat, group = _flatten(dom)
    q = torch.as_tensor(q_init, dtype=dom.z.dtype, device=dom.z.device)
    st = initialize_state(flat, q.reshape(flat.z.shape), dtini_min,
                          corrector_mode, group=group, n_groups=B,
                          stats=stats)
    st = st._replace(t=torch.zeros(B, dtype=q.dtype, device=q.device))
    return _batched_state(st, B)


def run_diffusive_batched(dom: DiffusiveDomain, st: DiffusiveState,
                          t_final: float, save_interval: float,
                          corrector_mode: str = "wavefront",
                          predictor_form: str | None = None,
                          stats: dict | None = None):
    """Route B independent domains ([B, R, C], ``domain.stack_domains``)
    in one loop, each with its own adaptive timestep and corrector
    convergence, as the reference runs ``diffnw`` once per tailwater
    domain; a finished domain holds its state, so results equal solo
    runs.  All domains share ``save_interval``, the series timesteps and
    the start time.  Returns (final batched state, [(t, q[B, R, C],
    y[B, R, C]), ...]) with the "device" dispatch's slots of
    ``run_diffusive``; padded reaches and columns (``valid`` False) carry
    garbage."""
    B = dom.z.shape[0]
    t0 = st.t.reshape(-1).cpu().numpy()
    t_start = float(t0[0])
    if not np.allclose(t0, t_start):
        raise ValueError("batched domains must share a start time")
    n_saves = int(round((t_final - t_start) / save_interval))
    if n_saves <= 0:
        return st, []
    flat, group = _flatten(dom)
    fst = _flat_state(st)
    qs = torch.zeros((n_saves,) + tuple(fst.q.shape), dtype=fst.q.dtype,
                     device=fst.q.device)
    ys = torch.zeros_like(qs)

    def on_save(g, t, s):
        k = _save_slot(t, t_start, save_interval, n_saves)
        if k is not None:
            lanes = group == g
            qs[k][lanes], ys[k][lanes] = s.q[lanes], s.y[lanes]

    fst = _time_loop(flat, fst, t_final, save_interval, corrector_mode,
                     predictor_form, group, B, on_save, stats)
    qs[n_saves - 1], ys[n_saves - 1] = fst.q, fst.y
    st = _batched_state(fst, B)
    shape = (B,) + tuple(st.q.shape[1:])
    return st, [(t_start + (k + 1) * save_interval, qs[k].reshape(shape),
                 ys[k].reshape(shape)) for k in range(n_saves)]


def shard_batched_domains(dom: DiffusiveDomain, st: DiffusiveState,
                          group=None):
    """This rank's lanes of a batched [B, ...] domain and state.

    Port of ``troute_tpu/diffusive/solver.py:shard_batched_domains``.
    Tailwater domains are independent (the reference runs one ``diffnw``
    call per domain), so the batch needs no communication while it runs:
    the lanes are padded to a multiple of the group's size (repeating lane
    0, dropped on read-back) and each rank of ``group`` (None: the default
    group) keeps one contiguous slice of them.  Returns (dom, st,
    n_real_lanes); ``gather_batched_saves`` puts the ranks' saves back
    together."""
    import torch.distributed as dist
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    b = int(dom.z.shape[0])
    pad = (-b) % world
    per = (b + pad) // world

    def prep(a):
        if not isinstance(a, torch.Tensor):
            return a
        if pad:
            a = torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])
        return a[rank * per:(rank + 1) * per]

    return (type(dom)(*[prep(a) for a in dom]),
            type(st)(*[prep(a) for a in st]), b)


def gather_batched_saves(saves, n_real: int, group=None):
    """Every rank's slice of ``run_diffusive_batched``'s saves (run on the
    lanes of ``shard_batched_domains``) as the saves of the whole batch,
    on every rank: [(t, q[B, R, C], y[B, R, C]), ...] with the pad lanes
    dropped.  One all-gather."""
    from troute_torch.parallel.group import Comm
    if not saves:
        return []
    local = torch.stack([torch.stack([q for _, q, _ in saves]),
                         torch.stack([y for _, _, y in saves])])
    parts = Comm(group, local.device).all_gather(local)
    full = torch.cat(parts, dim=2)[:, :, :n_real]
    return [(t, full[0, k], full[1, k]) for k, (t, _, _) in enumerate(saves)]

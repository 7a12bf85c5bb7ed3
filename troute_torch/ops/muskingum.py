"""Muskingum-Cunge segment solve in plain PyTorch.

Port of ``troute_tpu/ops/muskingum.py``: the NWM Muskingum-Cunge solver
(reference ``MCsingleSegStime_f2py_NOLOOP.f90:8-186``) as one masked vector
loop over a batch of segments.  Every lane is an independent segment; the
secant iteration runs as ``while active.any()`` with per-lane masks that
mirror the reference's ``do while``/``goto 110`` control flow, including
its quirks:

* the interval-1 X formula reads the aliased ``Qj_0`` slot left by the
  previous iteration; the interval-2 X formula reads the interval-1
  call's C1..C4;
* the channel-loss clamp applies to the interval-2 call only;
* the loop ends at the top-of-loop check or the small-depth break, then
  retries with h*1.33, h0*0.67 and 25 more iterations, at most 4 times;
* no-flow lanes come out exactly 0;
* the Courant diagnostics are taken from the final depth.

``solve_block`` is the plain version of the hand-written CUDA kernel B1 in
``troute_torch/csrc/mc_secant.cu``, and ``solve_block_skip`` that of its
block-skip form B2: the kernels' wrapper (``ops/muskingum_cuda.py``) runs
them for CPU tensors, and the tests and ``chip_smoke.py`` hold the kernels
to them.  All math runs in the dtype of the inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MINDEPTH = 0.01
MAXITER_INIT = 100
MAX_TRIES = 4

_P23 = 2.0 / 3.0
_P53 = 5.0 / 3.0


class MCOutput(NamedTuple):
    """Per-segment outputs of one Muskingum-Cunge timestep."""

    qdc: torch.Tensor     # discharge at segment outlet (m3/s)
    velc: torch.Tensor    # mean velocity (m/s)
    depthc: torch.Tensor  # flow depth (m)
    ck: torch.Tensor      # kinematic celerity (m/s), diagnostic
    cn: torch.Tensor      # Courant number, diagnostic
    X: torch.Tensor       # Muskingum weighting coefficient, diagnostic


class _Geometry(NamedTuple):
    twl: torch.Tensor
    h_lt: torch.Tensor
    h_gt: torch.Tensor
    area: torch.Tensor
    areac: torch.Tensor
    wp: torch.Tensor
    wpc: torch.Tensor
    r: torch.Tensor


def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.dtype).tiny


def _hydraulic_geometry(h, bfd, bw, twcc, z) -> _Geometry:
    """Trapezoidal main channel plus rectangular compound section; above
    bankfull with zero floodplain width the trapezoid extends upward."""
    twl = bw + 2.0 * z * h
    h_gt = torch.clamp_min(h - bfd, 0.0)
    h_lt = torch.minimum(bfd, h)
    extend_up = (h_gt > 0.0) & (twcc <= 0.0)
    h_gt = torch.where(extend_up, 0.0, h_gt)
    h_lt = torch.where(extend_up, h, h_lt)

    area = (bw + h_lt * z) * h_lt
    wp = bw + 2.0 * h_lt * torch.sqrt(1.0 + z * z)
    areac = twcc * h_gt
    wpc = torch.where(h_gt > 0.0, twcc + 2.0 * h_gt, 0.0)
    r = (area + areac) / torch.clamp_min(wp + wpc, _tiny(h))
    return _Geometry(twl, h_lt, h_gt, area, areac, wp, wpc, r)


def _celerity(geom, h, bfd, bw, twcc, z, n, ncc, s0):
    """Kinematic celerity Ck (reference ``.f90:248-268``)."""
    tiny = _tiny(h)
    sqrt_s0 = torch.sqrt(s0)
    r23, r53 = geom.r ** _P23, geom.r ** _P53
    denom_ch = bw + 2.0 * h * z
    ck_chan = (sqrt_s0 / n) * (
        _P53 * r23
        - _P23 * r53
        * (2.0 * torch.sqrt(1.0 + z * z) / torch.clamp_min(denom_ch, tiny)))
    denom_bf = bw + 2.0 * bfd * z
    ck_bf = (sqrt_s0 / n) * (
        _P53 * r23
        - _P23 * r53
        * (2.0 * torch.sqrt(1.0 + z * z) / torch.clamp_min(denom_bf, tiny)))
    safe_ncc = torch.where(ncc > 0.0, ncc, 1.0)
    ck_fp = (sqrt_s0 / safe_ncc) * _P53 * torch.clamp_min(h - bfd, 0.0) ** _P23
    area_tot = geom.area + geom.areac
    safe_area = torch.clamp_min(area_tot, tiny)
    ck_over = (ck_bf * geom.area + ck_fp * geom.areac) / safe_area

    overbank = (h > bfd) & (twcc > 0.0) & (ncc > 0.0)
    ck = torch.where(overbank, ck_over, torch.where(h > 0.0, ck_chan, 0.0))
    return torch.clamp_min(ck, 0.0)


def _secant2_h(h, interval, qj_in, c_in, qup, quc, qdp, ql,
               z, bw, bfd, twcc, s0, n, ncc, dt, dx):
    """One residual evaluation (reference ``secant2_h``, ``.f90:198-334``).

    ``qj_in`` is the caller's aliased Qj slot (read by the interval-1 X
    formula); ``c_in`` the (C1, C2, C3, C4) of the preceding interval-1
    call (read by the interval-2 X formula).  Returns (Qj, C1..C4, X).
    """
    tiny = _tiny(h)
    geom = _hydraulic_geometry(h, bfd, bw, twcc, z)
    ck = _celerity(geom, h, bfd, bw, twcc, z, n, ncc, s0)

    km = torch.where(ck > 0.0,
                     torch.maximum(dt, dx / torch.clamp_min(ck, tiny)), dt)

    if interval == 1:
        numer = qj_in
        lo = 0.0
    else:
        c1_in, c2_in, c3_in, c4_in = c_in
        numer = c1_in * qup + c2_in * quc + c3_in * qdp + c4_in
        lo = 0.25

    overbank = (h > bfd) & (twcc > 0.0) & (ncc > 0.0) & (ck > 0.0)
    width = torch.where(overbank, twcc, geom.twl)
    denom = 2.0 * width * s0 * ck * dx
    x_formula = 0.5 * (1.0 - numer / torch.where(denom != 0.0, denom, 1.0))
    x_clipped = torch.clamp_max(torch.clamp_min(x_formula, lo), 0.5)
    x = torch.where(ck > 0.0, x_clipped, 0.5)

    d = km * (1.0 - x) + dt / 2.0
    safe_d = torch.where(d != 0.0, d, 1.0)
    c1 = (km * x + dt / 2.0) / safe_d
    c2 = (dt / 2.0 - km * x) / safe_d
    c3 = (km * (1.0 - x) - dt / 2.0) / safe_d
    c4 = (ql * dt) / safe_d

    if interval == 2:
        base = c1 * qup + c2 * quc + c3 * qdp
        c4 = torch.where((c4 < 0.0) & (torch.abs(c4) > base), -base, c4)

    wp_tot = geom.wp + geom.wpc
    n_eff = (geom.wp * n + geom.wpc * ncc) / torch.clamp_min(wp_tot, tiny)
    q_manning = (1.0 / torch.clamp_min(n_eff, tiny)) \
        * (geom.area + geom.areac) * geom.r ** _P23 * torch.sqrt(s0)
    qj = torch.where(wp_tot > 0.0,
                     (c1 * qup + c2 * quc + c3 * qdp + c4) - q_manning, 0.0)
    return qj, c1, c2, c3, c4, x


def muskingum_cunge(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0,
                    depthp, dt, *, max_trips: int | None = None) -> MCOutput:
    """Route one timestep of Muskingum-Cunge for a batch of segments.

    The tensor arguments broadcast against each other (one lane per
    segment); ``dt`` is a Python float.  ``max_trips`` caps the total
    secant trips (None runs the full reference schedule).
    """
    args = torch.broadcast_tensors(qup, quc, qdp, ql, dx, bw, tw, twcc, n,
                                   ncc, cs, s0, depthp)
    return MCOutput(*solve_block(*[a.contiguous() for a in args], dt=dt,
                                 max_trips=max_trips))


def solve_block(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0,
                depthp, dt, max_trips: int | None = None,
                return_trips: bool = False):
    """Core solve on same-shaped tensors.

    Returns the tuple (qdc, velc, depthc, ck, cn, X).  The loop runs until
    every lane of the batch has converged; converged lanes hold their
    values, so each lane's result does not depend on the batch around it.
    ``return_trips`` appends two int32 counts per lane, as the kernel's
    ``trip`` makes them: the trips, passes of the loop in which the lane
    was still active (0 without flow), and the evaluations, the trips that
    passed the top check and evaluated the residual.
    """
    # PyTorch's CPU loops take the lanes past the last pair of whole SIMD
    # vectors through scalar code, whose pow can differ from the vector
    # code's in the last bit: a CPU batch is padded to whole vectors (no
    # flow, unit channel values), so that within one thread's grain
    # (32,768 lanes) no lane's result depends on the batch's length
    lanes = qup.numel()
    pad = -lanes % 64 if qup.device.type == "cpu" else 0
    if pad:
        def padded(a, fill):
            return torch.cat([a.reshape(-1), a.new_full((pad,), fill)])
        out = solve_block(
            *[padded(a, 0.0) for a in (qup, quc, qdp, ql)],
            *[padded(c, 1.0) for c in (dx, bw, tw, twcc, n, ncc, cs, s0)],
            padded(depthp, 0.0), dt, max_trips, return_trips)
        return tuple(o[:lanes].reshape(qup.shape) for o in out)

    dt = torch.full_like(qup, float(dt))

    z = torch.where(cs == 0.0, 1.0, 1.0 / torch.where(cs == 0.0, 1.0, cs))
    bfd = torch.where(
        bw > tw,
        bw / 0.00001,
        torch.where(bw == tw, bw / (2.0 * z), (tw - bw) / (2.0 * z)),
    )

    depthc0 = torch.clamp_min(depthp, 0.0)
    h = depthc0 * 1.33 + MINDEPTH
    h_0 = depthc0 * 0.67
    has_flow = (ql > 0.0) | (qup > 0.0) | (quc > 0.0) | (qdp > 0.0)

    zero = torch.zeros_like(h)
    qj0_slot = c1 = c2 = c3 = c4 = x = zero
    rerror = torch.ones_like(h)
    aerror = torch.full_like(h, MINDEPTH)
    it = torch.zeros(h.shape, dtype=torch.int32, device=h.device)
    maxiter = torch.full_like(it, MAXITER_INIT)
    tries = torch.zeros_like(it)
    active = has_flow.clone()

    def secant(hh, interval, qj_in, c_in):
        return _secant2_h(hh, interval, qj_in, c_in, qup, quc, qdp, ql,
                          z, bw, bfd, twcc, s0, n, ncc, dt, dx)

    lane_trips = torch.zeros_like(it)
    lane_evals = torch.zeros_like(it)
    trips = 0
    while bool(active.any()) and (max_trips is None or trips < max_trips):
        trips += 1
        lane_trips = lane_trips + active.to(torch.int32)
        # top-of-loop check (reference do-while condition, .f90:83)
        run = active & (rerror > 0.01) & (aerror >= MINDEPTH) \
            & (it <= maxiter)
        finished_loop = active & ~run
        lane_evals = lane_evals + run.to(torch.int32)

        qj0_new, c1a, c2a, c3a, c4a, _ = secant(h_0, 1, qj0_slot, None)
        qj_new, c1b, c2b, c3b, c4b, x2 = secant(h, 2, None,
                                                (c1a, c2a, c3a, c4a))

        diff = qj0_new - qj_new
        h_1 = torch.where(
            diff != 0.0,
            h - (qj_new * (h_0 - h)) / torch.where(diff != 0.0, diff, 1.0),
            h)
        h_1 = torch.where(h_1 < 0.0, h, h_1)
        pos = h > 0.0
        rerr = torch.where(
            pos, torch.abs((h_1 - h) / torch.where(pos, h, 1.0)), 0.0)
        aerr = torch.where(pos, torch.abs(h_1 - h), 0.9)
        h0_n = torch.clamp_min(h, 0.0)
        h_n = torch.clamp_min(h_1, 0.0)

        h = torch.where(run, h_n, h)
        h_0 = torch.where(run, h0_n, h_0)
        qj0_slot = torch.where(run, qj0_new, qj0_slot)
        c1 = torch.where(run, c1b, c1)
        c2 = torch.where(run, c2b, c2)
        c3 = torch.where(run, c3b, c3)
        c4 = torch.where(run, c4b, c4)
        x = torch.where(run, x2, x)
        rerror = torch.where(run, rerr, rerror)
        aerror = torch.where(run, aerr, aerror)
        it = torch.where(run, it + 1, it)

        # label 111: the loop ended at the top check or the small-depth
        # break (.f90:120-122); retry with a wider search space
        small_h = run & (h < MINDEPTH)
        at_111 = finished_loop | small_h
        hit_max = at_111 & (it >= maxiter)
        retry = hit_max & (tries + 1 <= MAX_TRIES)

        tries = torch.where(hit_max, tries + 1, tries)
        h = torch.where(retry, h * 1.33, h)
        h_0 = torch.where(retry, h_0 * 0.67, h_0)
        maxiter = torch.where(retry, maxiter + 25, maxiter)
        it = torch.where(retry, 0, it)
        active = active & ~(at_111 & ~retry)

    # final discharge (reference .f90:149-161)
    qmc = c1 * qup + c2 * quc + c3 * qdp + c4
    base = c1 * qup + c2 * quc + c3 * qdp
    big_loss = (c4 < 0.0) & (torch.abs(c4) > base)
    qdc_neg = torch.where(
        big_loss, 0.0,
        torch.maximum(c1 * qup + c2 * quc + c4, c1 * qup + c3 * qdp + c4))
    qdc = torch.where(qmc < 0.0, qdc_neg, qmc)

    # velocity from the legacy hydraulic-radius formula (.f90:163-169)
    twl = bw + 2.0 * z * h
    r_leg = (h * (bw + twl) / 2.0) / (
        bw + 2.0 * torch.sqrt(((twl - bw) / 2.0) ** 2.0 + h ** 2.0))
    velc = (1.0 / n) * r_leg ** _P23 * torch.sqrt(s0)

    qdc = torch.where(has_flow, qdc, 0.0)
    velc = torch.where(has_flow, velc, 0.0)
    depthc = torch.where(has_flow, h, 0.0)
    x_out = torch.where(has_flow, x, 0.0)

    # Courant diagnostics, always from the final h (.f90:183,342-367)
    tiny = _tiny(h)
    geom = _hydraulic_geometry(h, bfd, bw, twcc, z)
    sqrt_s0 = torch.sqrt(s0)
    denom_lt = bw + 2.0 * geom.h_lt * z
    ck_ch = (sqrt_s0 / n) * (
        _P53 * geom.r ** _P23
        - _P23 * geom.r ** _P53
        * (2.0 * torch.sqrt(1.0 + z * z) / torch.clamp_min(denom_lt, tiny)))
    safe_ncc = torch.where(ncc > 0.0, ncc, 1.0)
    ck_fp = (sqrt_s0 / safe_ncc) * _P53 * geom.h_gt ** _P23
    area_tot = geom.area + geom.areac
    ck = torch.clamp_min(
        torch.where(area_tot > 0.0,
                    (ck_ch * geom.area + ck_fp * geom.areac)
                    / torch.clamp_min(area_tot, tiny),
                    0.0),
        0.0)
    cn = ck * (dt / dx)

    if return_trips:
        return qdc, velc, depthc, ck, cn, x_out, lane_trips, lane_evals
    return qdc, velc, depthc, ck, cn, x_out


def solve_block_skip(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0,
                     depthp, dt, ran, prev, return_trips: bool = False):
    """``solve_block`` on every lane, then ``prev`` wherever ``ran`` is
    False: the plain version of the block-skip kernel.

    ``ran`` is the per-lane bool "this lane's block solves" (the wrapper
    expands its block flags to lanes); ``prev`` holds a previous call's six
    outputs in the order of the outputs.  Per-lane results of
    ``solve_block`` do not depend on the batch, so this agrees lane for
    lane with a kernel that solves only the active blocks.
    ``return_trips`` appends ``solve_block``'s two per-lane counts, 0 where
    ``ran`` is False.
    """
    solved = solve_block(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0,
                         depthp, dt, return_trips=return_trips)
    out = tuple(torch.where(ran, s, p) for s, p in zip(solved[:6], prev))
    if return_trips:
        out += tuple(torch.where(ran, c, 0) for c in solved[6:])
    return out

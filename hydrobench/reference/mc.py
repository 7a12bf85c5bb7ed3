"""The benchmark's plain Muskingum-Cunge secant, frozen.

``solve`` is a copy of the port's plain version (``solve_block`` of
``troute_torch/ops/muskingum.py``, itself the NWM solver
``MCsingleSegStime_f2py_NOLOOP.f90``) with the same arithmetic in the same
order, so that a later change to the program's plain version cannot move
the yardstick.  It differs in one way that changes no value: every few
trips it drops the lanes that have stopped (each lane's result depends on
its own inputs alone), so its cost follows the residual evaluations made
rather than the slowest lane times the batch.

``solve_lane`` is the same solver for one lane in plain Python, with the
reference's scalar control flow (only the branch a lane takes is
computed): the oracle the vector form is tested against, and the
arithmetic that ``hydrobench/roofline.py`` counts operations on.
"""

from __future__ import annotations

import math

import torch

MINDEPTH = 0.01
MAXITER_INIT = 100
MAX_TRIES = 4
P23 = 2.0 / 3.0
P53 = 5.0 / 3.0
# compact the working lanes once at most this share of them is active
COMPACT_BELOW = 0.5


def _tiny(t: torch.Tensor) -> float:
    return torch.finfo(t.dtype).tiny


def _geometry(h, bfd, bw, twcc, z):
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
    return twl, h_lt, h_gt, area, areac, wp, wpc, r


def _celerity(geom, h, bfd, bw, twcc, z, n, ncc, s0):
    tiny = _tiny(h)
    _, _, _, area, areac, _, _, r = geom
    sqrt_s0 = torch.sqrt(s0)
    r23, r53 = r ** P23, r ** P53
    denom_ch = bw + 2.0 * h * z
    ck_chan = (sqrt_s0 / n) * (
        P53 * r23
        - P23 * r53
        * (2.0 * torch.sqrt(1.0 + z * z) / torch.clamp_min(denom_ch, tiny)))
    denom_bf = bw + 2.0 * bfd * z
    ck_bf = (sqrt_s0 / n) * (
        P53 * r23
        - P23 * r53
        * (2.0 * torch.sqrt(1.0 + z * z) / torch.clamp_min(denom_bf, tiny)))
    safe_ncc = torch.where(ncc > 0.0, ncc, 1.0)
    ck_fp = (sqrt_s0 / safe_ncc) * P53 * torch.clamp_min(h - bfd, 0.0) ** P23
    safe_area = torch.clamp_min(area + areac, tiny)
    ck_over = (ck_bf * area + ck_fp * areac) / safe_area
    overbank = (h > bfd) & (twcc > 0.0) & (ncc > 0.0)
    ck = torch.where(overbank, ck_over, torch.where(h > 0.0, ck_chan, 0.0))
    return torch.clamp_min(ck, 0.0)


def _secant2_h(h, interval, qj_in, c_in, qup, quc, qdp, ql,
               z, bw, bfd, twcc, s0, n, ncc, dt, dx):
    tiny = _tiny(h)
    geom = _geometry(h, bfd, bw, twcc, z)
    twl, _, _, area, areac, wp, wpc, r = geom
    ck = _celerity(geom, h, bfd, bw, twcc, z, n, ncc, s0)
    km = torch.where(ck > 0.0,
                     torch.maximum(dt, dx / torch.clamp_min(ck, tiny)), dt)
    if interval == 1:
        numer, lo = qj_in, 0.0
    else:
        c1_in, c2_in, c3_in, c4_in = c_in
        numer = c1_in * qup + c2_in * quc + c3_in * qdp + c4_in
        lo = 0.25
    overbank = (h > bfd) & (twcc > 0.0) & (ncc > 0.0) & (ck > 0.0)
    width = torch.where(overbank, twcc, twl)
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
    wp_tot = wp + wpc
    n_eff = (wp * n + wpc * ncc) / torch.clamp_min(wp_tot, tiny)
    q_manning = (1.0 / torch.clamp_min(n_eff, tiny)) \
        * (area + areac) * r ** P23 * torch.sqrt(s0)
    qj = torch.where(wp_tot > 0.0,
                     (c1 * qup + c2 * quc + c3 * qdp + c4) - q_manning, 0.0)
    return qj, c1, c2, c3, c4, x


def solve(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp,
          dt: float):
    """One Muskingum-Cunge step for 1-D lanes of one dtype and device.

    Returns (qdc, velc, depthc, evals): discharge, velocity and depth per
    lane, and the int32 residual evaluations each lane made (the trips
    that passed the top-of-loop check)."""
    full = dict(qup=qup, quc=quc, qdp=qdp, ql=ql, dx=dx, bw=bw, twcc=twcc,
                n=n, ncc=ncc, s0=s0)
    dtf = torch.full_like(qup, float(dt))
    z = torch.where(cs == 0.0, 1.0, 1.0 / torch.where(cs == 0.0, 1.0, cs))
    bfd = torch.where(bw > tw, bw / 0.00001,
                      torch.where(bw == tw, bw / (2.0 * z),
                                  (tw - bw) / (2.0 * z)))
    full.update(dt=dtf, z=z, bfd=bfd)
    depthc0 = torch.clamp_min(depthp, 0.0)
    has_flow = (ql > 0.0) | (qup > 0.0) | (quc > 0.0) | (qdp > 0.0)

    zero = torch.zeros_like(qup)
    i32 = torch.zeros(qup.shape, dtype=torch.int32, device=qup.device)
    # loop state of every lane; the working lanes' copies are written back
    # here when the working set is compacted and at the end
    st = dict(h=depthc0 * 1.33 + MINDEPTH, h_0=depthc0 * 0.67, qj0=zero,
              c1=zero, c2=zero, c3=zero, c4=zero, x=zero,
              rerror=torch.ones_like(qup),
              aerror=torch.full_like(qup, MINDEPTH), it=i32,
              maxiter=torch.full_like(i32, MAXITER_INIT), tries=i32,
              evals=i32)
    lanes = torch.nonzero(has_flow).flatten()
    inp = {k: v[lanes] for k, v in full.items()}
    w = {k: v[lanes] for k, v in st.items()}
    active = torch.ones(lanes.shape, dtype=torch.bool, device=qup.device)
    final = {k: v.clone() for k, v in st.items()}

    def write_back():
        for k, v in w.items():
            final[k][lanes] = v

    def secant(hh, interval, qj_in, c_in):
        return _secant2_h(hh, interval, qj_in, c_in, inp["qup"], inp["quc"],
                          inp["qdp"], inp["ql"], inp["z"], inp["bw"],
                          inp["bfd"], inp["twcc"], inp["s0"], inp["n"],
                          inp["ncc"], inp["dt"], inp["dx"])

    while lanes.numel():
        n_active = int(active.sum())
        if n_active == 0:
            break
        if n_active <= COMPACT_BELOW * lanes.numel():
            write_back()
            keep = torch.nonzero(active).flatten()
            lanes = lanes[keep]
            inp = {k: v[keep] for k, v in inp.items()}
            w = {k: v[keep] for k, v in w.items()}
            active = active[keep]
        h, h_0 = w["h"], w["h_0"]
        run = active & (w["rerror"] > 0.01) & (w["aerror"] >= MINDEPTH) \
            & (w["it"] <= w["maxiter"])
        finished_loop = active & ~run
        w["evals"] = w["evals"] + run.to(torch.int32)
        qj0_new, c1a, c2a, c3a, c4a, _ = secant(h_0, 1, w["qj0"], None)
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
        w["h_0"] = torch.where(run, h0_n, h_0)
        w["qj0"] = torch.where(run, qj0_new, w["qj0"])
        for k, v in (("c1", c1b), ("c2", c2b), ("c3", c3b), ("c4", c4b),
                     ("x", x2), ("rerror", rerr), ("aerror", aerr)):
            w[k] = torch.where(run, v, w[k])
        it = torch.where(run, w["it"] + 1, w["it"])
        small_h = run & (h < MINDEPTH)
        at_111 = finished_loop | small_h
        hit_max = at_111 & (it >= w["maxiter"])
        retry = hit_max & (w["tries"] + 1 <= MAX_TRIES)
        w["tries"] = torch.where(hit_max, w["tries"] + 1, w["tries"])
        w["h"] = torch.where(retry, h * 1.33, h)
        w["h_0"] = torch.where(retry, w["h_0"] * 0.67, w["h_0"])
        w["maxiter"] = torch.where(retry, w["maxiter"] + 25, w["maxiter"])
        w["it"] = torch.where(retry, 0, it)
        active = active & ~(at_111 & ~retry)
    write_back()

    h = final["h"]
    c1, c2, c3, c4 = final["c1"], final["c2"], final["c3"], final["c4"]
    qmc = c1 * qup + c2 * quc + c3 * qdp + c4
    base = c1 * qup + c2 * quc + c3 * qdp
    big_loss = (c4 < 0.0) & (torch.abs(c4) > base)
    qdc_neg = torch.where(
        big_loss, 0.0,
        torch.maximum(c1 * qup + c2 * quc + c4, c1 * qup + c3 * qdp + c4))
    qdc = torch.where(qmc < 0.0, qdc_neg, qmc)
    twl = bw + 2.0 * z * h
    r_leg = (h * (bw + twl) / 2.0) / (
        bw + 2.0 * torch.sqrt(((twl - bw) / 2.0) ** 2.0 + h ** 2.0))
    velc = (1.0 / n) * r_leg ** P23 * torch.sqrt(s0)
    return (torch.where(has_flow, qdc, 0.0), torch.where(has_flow, velc, 0.0),
            torch.where(has_flow, h, 0.0), final["evals"])


# ----------------------------------------------------------- one lane

def _sqrt(v):
    return v.sqrt() if hasattr(v, "sqrt") else math.sqrt(v)


def lane_constants(bw, tw, twcc, n, ncc, cs, s0, dt):
    """What a lane computes once: side slope z, bankfull depth, and the
    square roots the celerity reuses."""
    z = 1.0 if cs == 0.0 else 1.0 / cs
    if bw > tw:
        bfd = bw / 0.00001
    elif bw == tw:
        bfd = bw / (2.0 * z)
    else:
        bfd = (tw - bw) / (2.0 * z)
    sqrt_s0 = _sqrt(s0)
    return dict(z=z, bfd=bfd, sqz=_sqrt(1.0 + z * z), sqrt_s0=sqrt_s0,
                ks_n=sqrt_s0 / n, ks_ncc=sqrt_s0 / ncc if ncc > 0.0 else 0.0,
                dt2=dt / 2.0)


def _secant_lane(h, interval, qj_in, c_in, qup, quc, qdp, ql, dx, bw, twcc,
                 n, ncc, s0, dt, L, tiny):
    z, bfd = L["z"], L["bfd"]
    twl = bw + 2.0 * z * h
    h_gt = max(h - bfd, 0.0)
    h_lt = min(bfd, h)
    if h_gt > 0.0 and twcc <= 0.0:
        h_gt, h_lt = 0.0, h
    area = (bw + h_lt * z) * h_lt
    wp = bw + 2.0 * h_lt * L["sqz"]
    areac = twcc * h_gt
    wpc = twcc + 2.0 * h_gt if h_gt > 0.0 else 0.0
    r = (area + areac) / max(wp + wpc, tiny)
    overbank = h > bfd and twcc > 0.0 and ncc > 0.0
    if overbank:
        ck_bf = L["ks_n"] * (P53 * r ** P23 - P23 * r ** P53 * (
            2.0 * L["sqz"] / max(bw + 2.0 * bfd * z, tiny)))
        ck_fp = L["ks_ncc"] * P53 * max(h - bfd, 0.0) ** P23
        ck = (ck_bf * area + ck_fp * areac) / max(area + areac, tiny)
    elif h > 0.0:
        ck = L["ks_n"] * (P53 * r ** P23 - P23 * r ** P53 * (
            2.0 * L["sqz"] / max(bw + 2.0 * h * z, tiny)))
    else:
        ck = 0.0
    ck = max(ck, 0.0)
    km = max(dt, dx / max(ck, tiny)) if ck > 0.0 else dt
    if interval == 1:
        numer, lo = qj_in, 0.0
    else:
        c1, c2, c3, c4 = c_in
        numer = c1 * qup + c2 * quc + c3 * qdp + c4
        lo = 0.25
    if ck > 0.0:
        width = twcc if overbank else twl
        denom = 2.0 * width * s0 * ck * dx
        x = min(max(0.5 * (1.0 - numer / (denom if denom != 0.0 else 1.0)),
                    lo), 0.5)
    else:
        x = 0.5
    d = km * (1.0 - x) + L["dt2"]
    if d == 0.0:
        d = 1.0
    c1 = (km * x + L["dt2"]) / d
    c2 = (L["dt2"] - km * x) / d
    c3 = (km * (1.0 - x) - L["dt2"]) / d
    c4 = (ql * dt) / d
    if interval == 2:
        base = c1 * qup + c2 * quc + c3 * qdp
        if c4 < 0.0 and abs(c4) > base:
            c4 = -base
    wp_tot = wp + wpc
    if wp_tot > 0.0:
        n_eff = (wp * n + wpc * ncc) / max(wp_tot, tiny)
        q_manning = (1.0 / max(n_eff, tiny)) * (area + areac) * r ** P23 \
            * L["sqrt_s0"]
        qj = (c1 * qup + c2 * quc + c3 * qdp + c4) - q_manning
    else:
        qj = 0.0
    return qj, (c1, c2, c3, c4), x


def evaluate(s: dict, qup, quc, qdp, ql, dx, bw, twcc, n, ncc, s0, dt, L,
             tiny) -> None:
    """One residual evaluation of the secant loop on the lane state ``s``
    (h, h_0, qj0, c, x, rerror, aerror, it), updated in place."""
    h, h_0 = s["h"], s["h_0"]
    args = (qup, quc, qdp, ql, dx, bw, twcc, n, ncc, s0, dt, L, tiny)
    qj0_new, c_a, _ = _secant_lane(h_0, 1, s["qj0"], None, *args)
    qj_new, c_b, x2 = _secant_lane(h, 2, None, c_a, *args)
    diff = qj0_new - qj_new
    h_1 = h - (qj_new * (h_0 - h)) / diff if diff != 0.0 else h
    if h_1 < 0.0:
        h_1 = h
    if h > 0.0:
        s["rerror"], s["aerror"] = abs((h_1 - h) / h), abs(h_1 - h)
    else:
        s["rerror"], s["aerror"] = 0.0, 0.9
    s.update(h=max(h_1, 0.0), h_0=max(h, 0.0), qj0=qj0_new, c=c_b, x=x2,
             it=s["it"] + 1)


def finish(s: dict, qup, quc, qdp, bw, n, L):
    """Discharge and velocity from the converged lane state."""
    c1, c2, c3, c4 = s["c"]
    h, z = s["h"], L["z"]
    base = c1 * qup + c2 * quc + c3 * qdp
    qmc = base + c4
    if qmc < 0.0:
        if c4 < 0.0 and abs(c4) > base:
            qdc = 0.0
        else:
            qdc = max(c1 * qup + c2 * quc + c4, c1 * qup + c3 * qdp + c4)
    else:
        qdc = qmc
    twl = bw + 2.0 * z * h
    r_leg = (h * (bw + twl) / 2.0) / (
        bw + 2.0 * _sqrt(((twl - bw) / 2.0) ** 2.0 + h ** 2.0))
    velc = (1.0 / n) * r_leg ** P23 * L["sqrt_s0"]
    return qdc, velc


def solve_lane(qup, quc, qdp, ql, dx, bw, tw, twcc, n, ncc, cs, s0, depthp,
               dt, tiny=2.2250738585072014e-308):
    """``solve`` for one lane in Python floats: (qdc, velc, depthc,
    evals)."""
    if not (ql > 0.0 or qup > 0.0 or quc > 0.0 or qdp > 0.0):
        return 0.0, 0.0, 0.0, 0
    L = lane_constants(bw, tw, twcc, n, ncc, cs, s0, dt)
    d0 = max(depthp, 0.0)
    s = dict(h=d0 * 1.33 + MINDEPTH, h_0=d0 * 0.67, qj0=0.0,
             c=(0.0, 0.0, 0.0, 0.0), x=0.0, rerror=1.0, aerror=MINDEPTH,
             it=0)
    maxiter, tries, evals = MAXITER_INIT, 0, 0
    while True:
        run = s["rerror"] > 0.01 and s["aerror"] >= MINDEPTH \
            and s["it"] <= maxiter
        if run:
            evals += 1
            evaluate(s, qup, quc, qdp, ql, dx, bw, twcc, n, ncc, s0, dt, L,
                     tiny)
        if run and s["h"] >= MINDEPTH:
            continue
        if s["it"] >= maxiter and tries + 1 <= MAX_TRIES:
            tries += 1
            s["h"], s["h_0"] = s["h"] * 1.33, s["h_0"] * 0.67
            maxiter += 25
            s["it"] = 0
            continue
        break
    qdc, velc = finish(s, qup, quc, qdp, bw, n, L)
    return qdc, velc, s["h"], evals

"""Hydraulic cross-section lookup tables for the diffusive-wave solver.

The port's copy of ``troute_tpu/diffusive/xsection.py``: the NumPy
builders verbatim (``build_xsec_tables``, ``build_xsec_table_natural``,
``_monotone_smooth``, ``_region_geometry``), and the device builder
``build_xsec_tables_torch`` in PyTorch in place of the jitted JAX one.

The reference builds an 11-column table per node by walking a synthetic
compound-trapezoid polygon at ``nel`` discrete elevations
(``kernel/diffusive/diffusive.f90:readXsection``, ``:2093-2443``).  The
polygon IS a compound trapezoid, so here the same quantities are computed in
closed form, vectorized over all nodes at once (host NumPy, one-time
preprocessing):

columns (0-indexed here, 1-indexed in the reference):
  0 elevation  1 area  2 wetted perimeter  3 hydraulic radius
  4 conveyance (sum of left/main/right sub-sections)  5 top width
  6 first moment of area  7 dP/dA  8 dK/dA  9 uniform flow K*sqrt(S0)
  10 compound 1/n (Einstein-Horton composite)

Geometry quirks reproduced exactly:
* a 1-cm triangular notch is carved below the main-channel bed (the table's
  datum ``z`` is lowered by 0.01 m);
* the first 5 elevation rows resolve the notch; the rest spread
  ``2*bankfull`` above it; the first row is evaluated 1e-5 above the notch
  bottom;
* floodplain outer walls are wetted up to ``timesDepth*bankfull``; internal
  sub-section walls are not wetted;
* above bankfull the main channel walls turn vertical (width ``tw``).
"""

from __future__ import annotations

import numpy as np
import torch

NEL = 501
TIMES_DEPTH = 4.0


def _region_geometry(e, z, bo, traps, tw, twcc, hbf):
    """Area/perimeter/topwidth of the three sub-sections at elevation e.

    All inputs broadcast; returns arrays stacked on a leading axis of 3
    (left floodplain, main channel, right floodplain).
    """
    notch_depth = 0.01
    z_notch = z - notch_depth
    xc3 = (twcc - tw) / 2.0          # floodplain bench width (each side)

    # --- main channel (region 2): notch + trapezoid + vertical above bank
    d_notch = np.clip(e - z_notch, 0.0, notch_depth)
    frac = d_notch / notch_depth
    notch_area = 0.5 * (bo * frac) * d_notch
    notch_side = np.sqrt((bo / 2.0) ** 2 + notch_depth ** 2)
    notch_peri = 2.0 * notch_side * frac
    notch_topw = bo * frac

    d_trap = np.clip(e - z, 0.0, hbf)
    trap_area = bo * d_trap + traps * d_trap ** 2
    trap_peri = 2.0 * d_trap * np.sqrt(1.0 + traps ** 2)
    trap_topw_add = 2.0 * traps * d_trap   # width beyond bo

    d_above = np.maximum(e - (z + hbf), 0.0)
    above_area = tw * d_above

    in_notch = e <= z
    main_area = notch_area + trap_area + above_area
    main_peri = notch_peri + trap_peri     # vertical walls above bank are
    main_topw = np.where(in_notch, notch_topw, bo + trap_topw_add)
    #             ^ internal (not wetted) per the reference polygon walk

    # --- floodplains (regions 1 and 3): rectangular bench above bank top,
    # outer wall wetted up to timesDepth*hbf
    d_fp = np.maximum(e - (z + hbf), 0.0)
    wall = np.minimum(d_fp, (TIMES_DEPTH - 1.0) * hbf)
    fp_area = xc3 * d_fp
    fp_peri = np.where(d_fp > 0.0, xc3 + wall, 0.0)
    fp_topw = np.where(d_fp > 0.0, xc3, 0.0)

    area = np.stack([fp_area, main_area, fp_area])
    peri = np.stack([fp_peri, main_peri, fp_peri])
    topw = np.stack([fp_topw, main_topw, fp_topw])
    return area, peri, topw


def build_xsec_tables(z, bo, traps, tw, twcc, mann, manncc, dx,
                      so_llm=0.0001, nel=NEL, chunk=256):
    """Build lookup tables for all nodes.

    Args:
        z, bo, traps, tw, twcc, mann, manncc: [R, C] node geometry
            (z = bed elevation, bo = bottom width, traps = side slope
            dx/dy, tw = bankfull top width, twcc = floodplain width)
        dx: [R, C] downstream segment lengths (dx[:, -1] unused)
        chunk: reaches per pass.  Large domains are processed in chunks
            so every [nel, chunk, C] temporary stays below glibc's mmap
            threshold and gets heap-reused: this VM faults fresh mmap
            pages at ~10 MB/s, so allocation — not arithmetic — is the
            cost at mainstem scale.

    Returns:
        (xsec_tab [R, C, 11, nel], z_adj [R, C]) where z_adj is the
        notch-lowered datum the solver must use.
    """
    R = np.shape(z)[0]
    if R > chunk:
        tabs, zs = [], []
        for lo in range(0, R, chunk):
            hi = min(lo + chunk, R)
            t, za = _build_xsec_tables_chunk(
                z[lo:hi], bo[lo:hi], traps[lo:hi], tw[lo:hi], twcc[lo:hi],
                mann[lo:hi], manncc[lo:hi], dx[lo:hi], so_llm, nel)
            tabs.append(t)
            zs.append(za)
        return np.concatenate(tabs), np.concatenate(zs)
    return _build_xsec_tables_chunk(z, bo, traps, tw, twcc, mann, manncc,
                                    dx, so_llm, nel)


def _build_xsec_tables_chunk(z, bo, traps, tw, twcc, mann, manncc, dx,
                             so_llm, nel):
    R, C = np.shape(z)
    z = np.asarray(z, np.float64)
    hbf = (tw - bo) / (2.0 * traps)

    # elevation grid built directly in [nel, R, C] layout: every bulk op
    # below runs elevation-major, and a transposed [R, C, nel] grid makes
    # them all cache-line-hostile (measured 25x slower at CONUS-mainstem
    # scale)
    z_notch = z - 0.01
    el_incr = 2.0 * hbf / (nel - 6.0)
    eval_el = np.empty((nel, R, C))
    # evaluate first row slightly above the notch bottom; the reference
    # ALSO stores the perturbed value in the elevation column
    # (el1(j,kkk) = el_now after the +0.00001, diffusive.f90:2296-2300,
    # :2368) — so eval_el is both the geometry argument and the stored grid
    eval_el[0] = z_notch + 1e-5
    for k in range(1, 5):
        eval_el[k] = z_notch + 0.01 * k / 4.0
    for k in range(5, nel):
        eval_el[k] = z + el_incr * (k - 4)

    e = eval_el                              # [nel, R, C]
    area3, peri3, topw3 = _region_geometry(
        e, z[None], bo[None], traps[None], tw[None], twcc[None], hbf[None])
    # area3 etc: [3, nel, R, C]

    # sub-section conveyance zeroed when peri <= TOLERANCE=1e-8
    # (reference diffusive.f90:2374-2377)
    with np.errstate(divide="ignore", invalid="ignore"):
        r3 = np.where(peri3 > 1e-8, area3 / peri3, 0.0)
        n3 = np.stack([np.broadcast_to(manncc, area3.shape[1:]),
                       np.broadcast_to(mann, area3.shape[1:]),
                       np.broadcast_to(manncc, area3.shape[1:])])
        conv3 = np.where(peri3 > 1e-8,
                         (1.0 / n3) * area3 * r3 ** (2.0 / 3.0), 0.0)

    area = area3.sum(axis=0)     # [nel, R, C]
    peri = peri3.sum(axis=0)
    topw = topw3.sum(axis=0)
    conv = conv3.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        radius = np.where(peri > 1e-10, area / peri, 0.0)

    # finite-difference dP/dA and dK/dA down the elevation grid
    dA = np.diff(area, axis=0)
    safe_dA = np.where(np.abs(dA) > 1e-12, dA, 1e-12)
    dPdA = np.concatenate([
        (peri[:1] / np.maximum(area[:1], 1e-12)),
        np.diff(peri, axis=0) / safe_dA])
    dKdA = np.concatenate([
        (conv[:1] / np.maximum(area[:1], 1e-12)),
        np.diff(conv, axis=0) / safe_dA])

    # first moment of area via midpoint accumulation (reference method);
    # centers use the STORED (perturbed-row-0) elevations like el1.
    # fm[j] = sum_{i<j} dA_i (el_j - c_i) = el_j * cumsum(dA)_j
    #         - cumsum(dA * c)_j  — O(nel) instead of the naive O(nel^2)
    el = eval_el
    centers = 0.5 * (el[1:] + el[:-1])
    z1 = np.zeros_like(area[:1])
    cs_a = np.concatenate([z1, np.cumsum(dA, axis=0)])
    cs_ac = np.concatenate([z1, np.cumsum(dA * centers, axis=0)])
    first_moment = el * cs_a - cs_ac

    # Einstein-Horton composite roughness; a dry section (possible at the
    # first table row when f32 cannot resolve z_notch + 1e-5, |z| > ~84 m)
    # degrades to the main-channel roughness instead of 1/sqrt(0) = inf
    peri_abs = np.abs(peri3)
    peri_tot = peri_abs.sum(axis=0)
    comp_mann = np.where(
        peri_tot > 1e-12,
        np.sqrt((peri_abs[0] * manncc ** 2 + peri_abs[1] * mann ** 2
                 + peri_abs[2] * manncc ** 2)
                / np.maximum(peri_tot, 1e-12)),
        mann)
    skk = 1.0 / comp_mann

    # uniform-flow column: K * sqrt(max(S0, so_llm)) with the slope of the
    # segment below (last node uses the slope above it) —
    # reference diffusive.f90:469-486
    slope = np.zeros((R, C))
    if C > 1:
        slope[:, :-1] = (z[:, :-1] - z[:, 1:]) / np.maximum(dx[:, :-1], 1e-12)
        slope[:, -1] = (z[:, -2] - z[:, -1]) / np.maximum(dx[:, -2], 1e-12)
    slope = np.maximum(slope, so_llm)
    uniform = conv * np.sqrt(slope)[None]

    tab = np.stack([el, area, peri, radius, conv, topw, first_moment,
                    dPdA, dKdA, uniform, np.broadcast_to(skk, area.shape)])
    # [11, nel, R, C] -> [R, C, 11, nel]
    tab = np.moveaxis(tab, (0, 1), (2, 3))
    return np.ascontiguousarray(tab), z_notch


def build_xsec_table_natural(x_bathy, z_bathy, mann_bathy, nel=NEL,
                             times_depth=TIMES_DEPTH):
    """Lookup table for one natural (surveyed bathymetry) cross-section.

    Reference ``readXsection_natural_mann_vertices``
    (``diffusive.f90:1756-2091``): piecewise-linear section between vertical
    end walls, Einstein-Horton composite roughness
    ``n_eq = (sum P_i n_i^1.5 / P)^(2/3)`` with wall roughness zeroed, and
    monotone smoothing of the conveyance and dK/dA curves.

    Args:
        x_bathy, z_bathy, mann_bathy: [n_sta] station/elevation/roughness

    Returns ([11, nel] table, z_datum) — columns as in
    ``build_xsec_tables`` (first moment/dPdA unset, matching the
    reference's natural path).
    """
    x = np.asarray(x_bathy, np.float64)
    x = x - x[0]
    z = np.asarray(z_bathy, np.float64)
    n = np.minimum(np.asarray(mann_bathy, np.float64), 0.15)

    el_min = z.min()
    el_max = z.max()
    el_range = (el_max - el_min) * times_depth
    wall_top = el_min + el_range + 1.0

    # vertices with vertical end walls; per-segment roughness = left vertex
    xv = np.concatenate([[x[0]], x, [x[-1]]])
    zv = np.concatenate([[wall_top], z, [wall_top]])
    nseg = xv.size - 1
    seg_mann = np.zeros(nseg)
    seg_mann[1:nseg] = n[:nseg - 1]
    seg_mann[0] = 0.0          # left wall
    seg_mann[nseg - 1] = 0.0   # right wall
    is_wall = np.zeros(nseg, bool)
    is_wall[0] = is_wall[-1] = True

    el = el_min + np.arange(nel) * (el_range / (nel - 1.0))
    el_eval = el.copy()
    el_eval[np.abs(el_eval - el_min) < 1e-8] += 1e-5
    e = el_eval[:, None]                       # [nel, 1]

    x1, x2 = xv[:-1][None], xv[1:][None]       # [1, nseg]
    z1, z2 = zv[:-1][None], zv[1:][None]
    lo = np.minimum(z1, z2)
    hi = np.maximum(z1, z2)
    dx_seg = x2 - x1
    dz = np.abs(z2 - z1)
    length = np.sqrt(dx_seg ** 2 + (z2 - z1) ** 2 + 1e-32)

    # wetted fraction of each segment at elevation e (clip at the waterline)
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.clip((e - lo) / np.where(hi > lo, hi - lo, 1.0), 0.0, 1.0)
        frac = np.where(hi <= lo, (e >= lo).astype(float), frac)
    wet_w = np.abs(dx_seg) * frac              # wetted horizontal extent
    wet_len = length * frac                    # wetted segment length
    # area under the waterline above the segment: trapezoid of the wetted part
    depth_lo = np.clip(e - lo, 0.0, None)
    depth_hi = np.clip(e - hi, 0.0, None)
    seg_area = 0.5 * (depth_lo + depth_hi) * np.abs(dx_seg) * \
        np.where(frac >= 1.0, 1.0, 0.0) \
        + np.where(frac < 1.0, 0.5 * depth_lo * wet_w, 0.0)

    area = seg_area.sum(axis=1)
    topw = wet_w.sum(axis=1)
    peri_seg = np.where(is_wall[None, :], 0.0, wet_len)
    peri = peri_seg.sum(axis=1)
    pmann = (peri_seg * seg_mann[None, :] ** 1.5).sum(axis=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        radius = np.where(peri > 1e-10, area / peri, 0.0)
        n_eq = np.where(peri > 1e-10, (pmann / peri) ** (2.0 / 3.0), 1.0)
        n_eq = np.maximum(n_eq, 1e-6)
        conv = np.where(peri > 1e-10,
                        (1.0 / n_eq) * area * radius ** (2.0 / 3.0), 0.0)

    dA = np.diff(area)
    dkda = np.concatenate([
        [conv[0] / max(area[0], 1e-12)],
        np.diff(conv) / np.where(np.abs(dA) > 1e-12, dA, 1e-12)])

    conv = _monotone_smooth(el, conv)
    dkda = _monotone_smooth(el, dkda)

    tab = np.zeros((11, nel))
    tab[0] = el_eval
    tab[1] = area
    tab[2] = peri
    tab[3] = radius
    tab[4] = conv
    tab[5] = topw
    tab[8] = dkda
    tab[10] = 1.0 / n_eq
    return tab, el_min


def _monotone_smooth(el, v):
    """Reference's increasing-curve repair (diffusive.f90:1951-2014):
    where the curve dips, bridge linearly to the next larger value."""
    v = v.copy()
    nel = v.size
    iel = 1
    while iel < nel:
        if v[iel] <= v[iel - 1]:
            ii = iel
            while ii < nel - 1 and v[ii] < v[iel - 1]:
                ii += 1
            if ii >= nel - 1 and v[ii] < v[iel - 1]:
                v[ii] = 1.01 * v[iel - 1]
            slope = (v[ii] - v[iel - 1]) / max(el[ii] - el[iel - 1], 1e-12)
            for k in range(iel, ii):
                v[k] = v[iel - 1] + slope * (el[k] - el[iel - 1])
            iel = ii
        else:
            iel += 1
    return v


def build_xsec_tables_torch(z, bo, traps, tw, twcc, mann, manncc, dx, *,
                            device, dtype=torch.float64, so_llm=0.0001,
                            nel=NEL):
    """The synthetic-trapezoid tables built on ``device`` (the math of
    ``build_xsec_tables``, as ``troute_tpu/diffusive/xsection.py:332-458``
    writes it): a [R, C, 11, nel] tensor and the notch-lowered datum
    ``z_adj`` [R, C] as NumPy.  The NumPy builder materialises several
    [nel, R, C] float64 temporaries on the host; here they live on the
    card and only the table is kept."""
    z_np = np.asarray(z, np.float64)
    z, bo, traps, tw, twcc, mann, manncc, dx = (
        torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)
        for a in (z, bo, traps, tw, twcc, mann, manncc, dx))
    hbf = (tw - bo) / (2.0 * traps)
    z_notch = z - 0.01
    el_incr = 2.0 * hbf / (nel - 6.0)
    k = torch.arange(nel, dtype=dtype, device=device)[:, None, None]
    el = torch.where(
        k == 0, z_notch[None] + 1e-5,
        torch.where(k < 5, z_notch[None] + 0.01 * k / 4.0,
                    z[None] + el_incr[None] * (k - 4)))

    notch_depth = 0.01
    xc3 = (twcc - tw) / 2.0
    zb, bob, trb, twb, hbfb = (a[None] for a in (z, bo, traps, tw, hbf))
    znb = zb - notch_depth
    d_notch = torch.clamp(el - znb, 0.0, notch_depth)
    frac = d_notch / notch_depth
    notch_area = 0.5 * (bob * frac) * d_notch
    notch_side = torch.sqrt((bob / 2.0) ** 2 + notch_depth ** 2)
    notch_peri = 2.0 * notch_side * frac
    notch_topw = bob * frac
    d_trap = torch.minimum(torch.clamp_min(el - zb, 0.0), hbfb)
    trap_area = bob * d_trap + trb * d_trap ** 2
    trap_peri = 2.0 * d_trap * torch.sqrt(1.0 + trb ** 2)
    trap_topw_add = 2.0 * trb * d_trap
    d_above = torch.clamp_min(el - (zb + hbfb), 0.0)
    above_area = twb * d_above
    in_notch = el <= zb
    main_area = notch_area + trap_area + above_area
    main_peri = notch_peri + trap_peri
    main_topw = torch.where(in_notch, notch_topw, bob + trap_topw_add)
    d_fp = torch.clamp_min(el - (zb + hbfb), 0.0)
    wall = torch.minimum(d_fp, (TIMES_DEPTH - 1.0) * hbfb)
    fp_area = xc3[None] * d_fp
    fp_peri = torch.where(d_fp > 0.0, xc3[None] + wall, 0.0)
    fp_topw = torch.where(d_fp > 0.0, xc3[None], 0.0)

    def sub_conv(a, p, n):
        r = torch.where(p > 1e-8, a / p, 0.0)
        return torch.where(p > 1e-8, (1.0 / n) * a * r ** (2.0 / 3.0), 0.0)

    conv = (sub_conv(fp_area, fp_peri, manncc[None]) * 2.0
            + sub_conv(main_area, main_peri, mann[None]))
    area = 2.0 * fp_area + main_area
    peri = 2.0 * fp_peri + main_peri
    topw = 2.0 * fp_topw + main_topw
    radius = torch.where(peri > 1e-10, area / peri, 0.0)

    dA = torch.diff(area, dim=0)
    safe_dA = torch.where(torch.abs(dA) > 1e-12, dA, 1e-12)
    dPdA = torch.cat([peri[:1] / torch.clamp_min(area[:1], 1e-12),
                      torch.diff(peri, dim=0) / safe_dA])
    dKdA = torch.cat([conv[:1] / torch.clamp_min(area[:1], 1e-12),
                      torch.diff(conv, dim=0) / safe_dA])

    centers = 0.5 * (el[1:] + el[:-1])
    z1 = torch.zeros_like(area[:1])
    cs_a = torch.cat([z1, torch.cumsum(dA, dim=0)])
    cs_ac = torch.cat([z1, torch.cumsum(dA * centers, dim=0)])
    first_moment = el * cs_a - cs_ac

    # dry-section guard: see build_xsec_tables (f32 cannot resolve
    # z_notch + 1e-5 at |z| > ~84 m, making row 0's perimeter 0)
    peri_fp = torch.abs(fp_peri)
    peri_mn = torch.abs(main_peri)
    peri_tot = 2.0 * peri_fp + peri_mn
    comp_mann = torch.where(
        peri_tot > 1e-12,
        torch.sqrt((2.0 * peri_fp * manncc[None] ** 2
                    + peri_mn * mann[None] ** 2)
                   / torch.clamp_min(peri_tot, 1e-12)),
        mann[None])
    skk = 1.0 / comp_mann

    slope = torch.zeros_like(z)
    if z.shape[1] > 1:
        slope[:, :-1] = (z[:, :-1] - z[:, 1:]) / torch.clamp_min(dx[:, :-1],
                                                                 1e-12)
        slope[:, -1] = (z[:, -2] - z[:, -1]) / torch.clamp_min(dx[:, -2],
                                                               1e-12)
    slope = torch.clamp_min(slope, so_llm)
    uniform = conv * torch.sqrt(slope)[None]

    tab = torch.stack([el, area, peri, radius, conv, topw, first_moment,
                       dPdA, dKdA, uniform, skk])
    return tab.permute(2, 3, 0, 1).contiguous(), z_np - 0.01

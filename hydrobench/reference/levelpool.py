"""The benchmark's level-pool reservoir step, frozen: a copy of the port's
plain ``levelpool_step`` (``troute_torch/ops/levelpool.py``, the NWM
``LEVELPOOL_PHYSICS``, ``module_levelpool.F:233-427``): storage routing
dH/dt = (I - Q(H)) / A with the 3-stage Runge-Kutta scheme, every lake in
one vector step.

Parameters are an [n_lakes, >= 8] tensor in the column order area (km2),
max elevation, orifice area, orifice coefficient, orifice elevation, weir
coefficient, weir elevation, weir length; the dam length is 10 m.
"""

from __future__ import annotations

import torch

GRAVITY = 9.81
DAM_LENGTH = 10.0


def _discharge(h_weir, h_orifice, h_overtop_test, p):
    area, max_depth, o_area, o_coeff, o_elev, w_coeff, w_elev, w_len = p
    max_weir_depth = max_depth - w_elev
    dh = torch.minimum(h_weir - w_elev, max_weir_depth)
    head = h_orifice - o_elev
    tmp1 = o_coeff * o_area * torch.sqrt(
        2.0 * GRAVITY * torch.clamp_min(head, 0.0))
    tmp2 = w_coeff * w_len * torch.clamp_min(dh, 0.0) ** 1.5
    over = w_coeff * (w_len * DAM_LENGTH) \
        * torch.clamp_min(h_overtop_test - max_depth, 0.0) ** 1.5
    return torch.where(
        h_overtop_test > max_depth, tmp1 + tmp2 + over,
        torch.where(dh > 0.0, tmp1 + tmp2,
                    torch.where(h_orifice > o_elev, tmp1, 0.0)))


def step(H, qi0, qi1, ql, dt: float, params: torch.Tensor):
    """All lakes one step of ``dt`` seconds from elevation ``H`` with
    inflows ``qi0`` (previous) and ``qi1`` (current) and lateral inflow
    ``ql``: (outflow, new elevation)."""
    p = tuple(params[:, k] for k in range(8))
    it = qi0
    itdt_3 = qi0 + (qi1 + ql - qi0) * 0.33
    itdt_2_3 = qi0 + (qi1 + ql - qi0) * 0.67
    sap = p[0] * 1.0e6
    has_area = sap > 0.0
    safe_sap = torch.where(has_area, sap, 1.0)
    d1 = _discharge(H, H, H, p)
    dh1 = torch.where(has_area, ((it - d1) / safe_sap) * dt, 0.0)
    h2 = H + dh1 / 3.0
    d2 = _discharge(h2, h2, H, p)
    dh2 = torch.where(has_area, ((itdt_3 - d2) / safe_sap) * dt, 0.0)
    h3 = H + 0.667 * dh2
    d3 = _discharge(h3, h3, H, p)
    dh3 = torch.where(has_area, ((itdt_2_3 - d3) / safe_sap) * dt, 0.0)
    H_new = H + dh1 / 4.0 + 0.75 * dh3
    return _discharge(H_new, H_new, H_new, p), H_new

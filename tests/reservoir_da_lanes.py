"""Reservoir lanes that take every branch of the typed reservoir DA, for
the tests that hold the level-pool kernel's DA form to the plain level
pool and ``typed_reservoir_dispatch``, and the comparison those tests
make.

``da_lanes`` builds ``per_branch`` lakes for each name of ``BRANCHES``:
the lake's type, DA state, observations and inflow are chosen so that its
DA takes that branch at the time ``NOW``; every other field is drawn at
random, NaN included, so that a lake of one kind shows whether the
others' states are copied through.
"""

import numpy as np
import torch

from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.ops.reservoir_da import (GreatLakesDAState, HybridDAState,
                                           RfcDAState,
                                           typed_reservoir_dispatch)
from troute_torch.routing.engine import ReservoirDAData

DT = 300.0
NOW = 36000.0
MONTH = 4
N_HOBS = 193        # 48 h of 15-min persistence observations
N_COUNTS = 76       # RFC series: 28 h before the hour, 48 forecast hours
N_GOBS = 10
LIMIT_S = 11.0 * 86400.0

# (wbody_type, branch); hybrid 2-3, RFC 4-5, Great Lakes 6, level pool 1
BRANCHES = (
    (2, "hybrid fresh"), (3, "hybrid fresh, negative observation"),
    (2, "hybrid stale"), (3, "hybrid not found"),
    (2, "hybrid update time before every observation"),
    (3, "hybrid not searching"), (2, "hybrid persistence-cycle bump"),
    (3, "hybrid limit hit"), (2, "hybrid NaN persisted value"),
    (3, "hybrid projected storage <= 0"),
    (2, "hybrid maximum storage reached"),
    (4, "rfc advance"), (5, "rfc advance"), (4, "rfc no advance"),
    (5, "rfc index at the count"), (4, "rfc index clamped"),
    (4, "rfc out of window"), (5, "rfc out of window"),
    (4, "rfc negative outflow, walk back"),
    (5, "rfc negative outflow, walk back"),
    (4, "rfc negative outflow, no walk back"),
    (5, "rfc negative outflow, no walk back"),
    (6, "great lakes take"), (6, "great lakes stale"),
    (6, "great lakes keep the previous value"),
    (6, "great lakes no observation yet"),
    (6, "great lakes climatology after the limit"),
    (6, "great lakes previous value, not searching"),
    (1, "level pool"), (0, "level pool, type 0"))

# LevelpoolParams' columns (area, max_depth, orifice_area, orifice_coeff,
# orifice_elev, weir_coeff, weir_elev, weir_length, ifd)
_LP_RANGES = ((0.5, 20.0), (9.0, 11.0), (0.5, 2.0), (0.05, 0.2), (6.0, 8.0),
              (0.3, 0.5), (8.5, 9.5), (5.0, 20.0), (0.0, 1.0))


def da_lanes(dtype, device, per_branch: int = 16, seed: int = 0) -> dict:
    """The lanes, lake ``i`` taking ``branch[i]``: dict of ``H``,
    ``inflow``, ``p`` (``LevelpoolParams``), ``res_da``
    (``ReservoirDAData``), ``states`` (hybrid, RFC, Great Lakes), ``now``,
    ``month_i`` and ``branch`` (numpy strings)."""
    rng = np.random.default_rng(seed)
    kinds = np.repeat([k for k, _ in BRANCHES], per_branch)
    branch = np.repeat([b for _, b in BRANCHES], per_branch)
    n = kinds.size

    def u(lo, hi, shape=n):
        return rng.uniform(lo, hi, shape)

    def nan_some(a, share):
        a = np.array(a, dtype=float)
        a[rng.random(a.shape) < share] = np.nan
        return a

    def at(name):
        return branch == name

    wb = np.stack([u(lo, hi) for lo, hi in _LP_RANGES], axis=1)
    wb[:, 1] = np.maximum(wb[:, 1], wb[:, 6] + 0.2)
    md, oe = wb[:, 1], wb[:, 4]
    H = u(oe - 1.0, md + 0.5)
    inflow = u(0.0, 500.0)

    # hybrid persistence: observation times every 15 min to 450 s before
    # now, observations with a fifth missing
    hyb_time = NOW - 450.0 - 900.0 * np.arange(N_HOBS)[::-1]
    hobs = nan_some(u(1.0, 50.0, (n, N_HOBS)), 0.2)
    po = nan_some(u(1.0, 50.0), 0.3)
    ut = NOW - 900.0 * rng.integers(0, 4, n)
    pidx = rng.integers(0, 15, n).astype(float)
    put = NOW + 900.0 * rng.integers(-3, 4, n)

    fresh = np.char.startswith(branch, "hybrid fresh") \
        | at("hybrid projected storage <= 0") \
        | at("hybrid maximum storage reached")
    hobs[fresh, -8:] = u(1.0, 50.0, (int(fresh.sum()), 8))
    ut[fresh] = NOW - 450.0
    neg = at("hybrid fresh, negative observation")
    hobs[neg, -1] = -5.0
    b = at("hybrid stale")            # the only observation 48 h old
    hobs[b] = np.nan
    hobs[b, 0] = 7.0
    ut[b] = NOW
    b = at("hybrid not found")
    hobs[b] = np.nan
    ut[b] = NOW
    put[b] = NOW - 300.0
    b = at("hybrid update time before every observation")
    ut[b] = hyb_time[0] - 900.0
    hobs[b, 0] = 9.0
    not_searching = at("hybrid not searching") \
        | at("hybrid persistence-cycle bump") | at("hybrid limit hit") \
        | at("hybrid NaN persisted value")
    ut[not_searching] = NOW + 900.0
    put[at("hybrid not searching") | at("hybrid NaN persisted value")] = \
        NOW + 300.0
    b = at("hybrid persistence-cycle bump")
    put[b] = NOW - 300.0
    pidx[b] = rng.integers(0, 12, int(b.sum()))
    b = at("hybrid limit hit")
    put[b] = NOW
    pidx[b] = rng.integers(12, 15, int(b.sum()))
    po[at("hybrid NaN persisted value")] = np.nan
    b = at("hybrid projected storage <= 0")
    H[b] = oe[b] - u(0.5, 1.0, int(b.sum()))
    hobs[b, -1] = 400.0
    inflow[b] = 1.0
    b = at("hybrid maximum storage reached")
    wb[b, 0] = 0.5
    H[b] = md[b] - 0.01
    hobs[b, -1] = 0.5
    inflow[b] = 450.0

    # RFC forecasts: 76 hourly values, the file's index 28
    series = u(0.5, 50.0, (n, N_COUNTS))
    counts = np.full(n, N_COUNTS, np.int32)
    use = rng.random(n) < 0.9
    timestep = np.full(n, 3600.0)
    persist = NOW + 86400.0 * u(-1.0, 10.0)
    ts = np.full(n, 28, np.int32)
    rut = NOW + 3600.0 * u(-1.0, 1.0)
    rfc = np.char.startswith(branch, "rfc")
    use[rfc] = True
    persist[rfc] = NOW + 86400.0 * 10.0
    rut[at("rfc advance") | at("rfc index clamped")] = NOW - 100.0
    rut[at("rfc no advance")] = NOW + 1000.0
    b = at("rfc index at the count")
    counts[b] = 40
    ts[b] = 40
    rut[b] = NOW - 100.0
    b = at("rfc index clamped")
    counts[b] = 120
    ts[b] = np.where(np.arange(int(b.sum())) % 2, 100, -3)
    b = at("rfc out of window")
    half = np.arange(int(b.sum())) % 2 == 0
    use[np.flatnonzero(b)[half]] = False
    persist[np.flatnonzero(b)[~half]] = NOW - 1.0
    b = at("rfc negative outflow, walk back")
    series[b, 28:30] = -600.0
    series[b, 20:28] = nan_some(series[b, 20:28], 0.3)
    rut[b] = NOW + 1000.0
    b = at("rfc negative outflow, no walk back")
    ts[b] = 5
    series[b, :6] = -600.0
    rut[b] = NOW + 1000.0

    # Great Lakes: hourly observations, the newest half an hour ago
    gl_time = np.tile(NOW - 1800.0 - 3600.0 * np.arange(N_GOBS)[::-1], (n, 1))
    gl_obs = nan_some(u(50.0, 200.0, (n, N_GOBS)), 0.2)
    clim = u(50.0, 150.0, (n, 12))
    gao = nan_some(u(50.0, 200.0), 0.3)
    gat = NOW - u(0.0, 2.0 * LIMIT_S)
    gut = NOW + 3600.0 * u(-1.0, 1.0)
    gl = kinds == 6
    gut[gl] = NOW - 10.0
    gl_obs[at("great lakes take"), -1] = u(50.0, 200.0,
                                           int(at("great lakes take").sum()))
    b = at("great lakes stale")
    gl_time[b] -= LIMIT_S
    gl_obs[b, -1] = 120.0
    gl_obs[at("great lakes keep the previous value"), -1] = np.nan
    gl_time[at("great lakes no observation yet")] += 86400.0
    b = at("great lakes climatology after the limit")
    gut[b] = NOW + 100.0
    gat[b] = NOW - LIMIT_S - 10.0
    b = at("great lakes previous value, not searching")
    gut[b] = NOW + 100.0
    gat[b] = NOW - 100.0

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    res_da = ReservoirDAData.inactive(n, 12, device=device,
                                      dtype=dtype)._replace(
        wbody_type=torch.as_tensor(kinds, dtype=torch.int32, device=device),
        hybrid_obs=t(hobs), hybrid_obs_time=t(hyb_time),
        rfc_series=t(series),
        rfc_counts=torch.as_tensor(counts, device=device),
        rfc_use=torch.as_tensor(use, device=device),
        rfc_timestep=t(timestep), rfc_persist_seconds=t(persist),
        gl_obs=t(gl_obs), gl_obs_time=t(gl_time), gl_climatology=t(clim))
    states = (HybridDAState(t(po), t(ut), t(pidx), t(put)),
              RfcDAState(torch.as_tensor(ts, device=device), t(rut)),
              GreatLakesDAState(t(gao), t(gat), t(gut)))
    return dict(H=t(H), inflow=t(inflow),
                p=LevelpoolParams.from_array(wb, device=device, dtype=dtype),
                res_da=res_da, states=states, now=NOW, month_i=MONTH,
                branch=branch)


def plain_dispatch(res_da, states, H, inflow, lp_out, lp_elev, now, month_i,
                   p, dt):
    """``typed_reservoir_dispatch`` of ``res_da`` on the level pool's
    result: (outflow, elevation, the depth column's value, hybrid, RFC and
    Great Lakes states)."""
    hyb, rfc, gl = states
    return typed_reservoir_dispatch(
        res_da.wbody_type, res_da.hybrid_obs, res_da.hybrid_obs_time, hyb,
        res_da.rfc_series, res_da.rfc_counts, res_da.rfc_use,
        res_da.rfc_timestep, res_da.rfc_persist_seconds, rfc, res_da.gl_obs,
        res_da.gl_obs_time, res_da.gl_climatology, gl,
        res_da.obs_lookback_hours, H, inflow, lp_out, lp_elev, now, month_i,
        p.area, p.max_depth, p.orifice_elev, dt)


def same(a, b) -> bool:
    """One dtype and shape, NaN where NaN, equal elsewhere (``torch.equal``
    on the values)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return torch.equal(torch.isnan(a), torch.isnan(b)) \
        and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))

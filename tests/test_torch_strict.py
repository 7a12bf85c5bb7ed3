"""Port parity for the strict fixed-point mode of ``route_stepped``
(``troute_torch/routing/engine.py``): the accelerators, the Jacobi sweep
driver against the JAX driver and against JAX ``route()``'s level scan,
two edge cases of ``test_stepped.py``, and typed reservoir DA against the
scalar oracle.

Both sides get the same NumPy inputs from a seed, carried over with
``troute_torch.convert``; the JAX side runs its Pallas kernels in
interpret mode, as the JAX tests do.

Tolerances:
- accelerators, f64: rtol 1e-14, atol 0 (elementwise products and
  quotients in the same order; measured bit for bit);
- strict ``route_stepped``, f64, against the JAX driver and against the
  level scan: rtol 1e-9, atol 1e-9 (``test_engine.py:241-261``); the
  per-step sweep counts equal the JAX driver's exactly;
- f32 large flows against JAX: ``test_torch_skip.assert_strict_f32``
  (rtol 1e-4, atol 1e-4, the JAX package's bar for two strict
  trajectories);
- typed reservoir DA against the scalar oracle, f64: rtol 1e-7, atol 1e-9
  (the level scan's bar, ``test_engine_reservoir_da.py:187-330``): the
  fixed point stops where a sweep moves q by at most 1e-9, which leaves
  it within ~1e-9 of the level scan on this shallow network.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from troute_tpu.network.topology import build_topology, from_connections
from troute_tpu.routing import engine as jeng
from troute_torch import convert
from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.ops.reservoir_da import (
    GreatLakesDAState, HybridDAState, RfcDAState)
from troute_torch.routing import engine as teng

import test_engine_reservoir_da as trd
from reference_network import simulate_reference
from test_engine import _run_engine, _setup
from test_torch_engine import _compare, _conn_case, _run_both
from test_torch_skip import assert_strict_f32

torch.set_num_threads(1)

DT = 300.0
STRICT = dict(assume_short_ts=False, strict_iterative=True)


def assert_strict_f64(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9,
                               err_msg=what)


def _gain_inputs():
    """Lanes with ck > 0 and ck == 0, X at and inside its bounds, and
    drives that moved by more than, exactly at and less than the floor
    16 eps (|quc| + 1), plus a response that is no contraction."""
    rng = np.random.default_rng(21)
    n = 64
    ck = rng.uniform(0.2, 3.0, n)
    ck[:8] = 0.0
    x = rng.uniform(0.0, 0.5, n)
    x[8:12] = (0.0, 0.5, 0.25, 0.5)
    dx = rng.uniform(50.0, 5000.0, n)
    quc = rng.uniform(0.0, 50.0, n)
    floor = 16.0 * np.finfo(np.float64).eps * (np.abs(quc) + 1.0)
    du = rng.uniform(-1.0, 1.0, n)
    du[12:20] = floor[12:20] * np.array([0.5, 1.0, 0.0, 0.99, 2.0, -0.5,
                                         -1.0, 1e-3])
    quc_prev = quc - du
    g_prev = rng.uniform(0.0, 50.0, n)
    q_new = g_prev + du * rng.uniform(-0.5, 0.9, n)
    q_new[20:24] = g_prev[20:24] + 3.0 * du[20:24]      # |g| >= 1
    return [ck, x, dx, q_new, g_prev, quc, quc_prev]


def test_accelerators_vs_jax_f64():
    ck, x, dx, q_new, g_prev, quc, quc_prev = _gain_inputs()
    j = [jnp.asarray(a) for a in (ck, x, dx, q_new, g_prev, quc, quc_prev)]
    t = [torch.as_tensor(a) for a in (ck, x, dx, q_new, g_prev, quc,
                                      quc_prev)]

    def same(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-14, atol=0)

    same(teng.mc_linear_gain(*t[:3], DT),
         jeng.mc_linear_gain(*j[:3], DT, jnp.float64))
    same(teng.mc_linear_gain(*t[:3], DT, *t[3:]),
         jeng.mc_linear_gain(*j[:3], DT, jnp.float64, *j[3:]))
    for emp_ok in (False, True):
        same(teng.accel_gain(*t[:3], DT, *t[3:], emp_ok=emp_ok),
             jeng.accel_gain(*j[:3], DT, jnp.float64, *j[3:],
                             emp_ok=emp_ok))
    # the linear jump with a banded upstream sum of both packages
    n = 4096
    rng = np.random.default_rng(2)
    ids = np.arange(1, n + 1)
    down = ids[np.minimum(np.arange(n) + rng.integers(1, 5, n), n - 1)]
    down[-1] = 0
    jnet = jeng.network_arrays_from_topology(build_topology(ids, down),
                                             need_levels=False)
    tnet = convert.from_network_arrays(jnet, device="cpu")
    gain = rng.uniform(-0.2, 0.9, n)
    dq = rng.uniform(-1.0, 1.0, n)
    q = rng.uniform(0.0, 2.0, n)
    same(teng.apply_linear_accel(*[torch.as_tensor(a) for a in (q, dq, gain)],
                                 tnet.uplan, 8),
         jeng.apply_linear_accel(*[jnp.asarray(a) for a in (q, dq, gain)],
                                 jnet.uplan, 8))


def test_accel_enabled_resolves_like_jax():
    for v in ("auto", True, False):
        cfg = teng.RoutingConfig(dt=DT, nts=1, strict_accel=v)
        jcfg = jeng.RoutingConfig(dt=DT, nts=1, strict_accel=v)
        for stepped in (False, True):
            assert (teng._accel_enabled(cfg, stepped)
                    == jeng._accel_enabled(jcfg, stepped))


def test_route_stepped_strict_f64_vs_jax_and_level_scan():
    """``test_engine._setup``'s network (reservoir and gage), 24 steps,
    f64: the port's strict driver against the JAX driver (accelerator on,
    as "auto" resolves) and against JAX ``route()``'s level scan."""
    nts = 24
    topo, chan, lp, q0, d0, elev0, qlat, gages = _conn_case(nts)
    cfg = jeng.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=4, **STRICT)
    out_t, out_j = _run_both(topo, chan, lp, cfg, q0, d0, elev0, qlat,
                             np.float64, gages=gages)
    _compare(out_t, out_j, assert_strict_f64)
    assert out_t["strict_sweeps"] == out_j["strict_sweeps"]
    calls = out_t["strict_mc_calls"]
    assert calls == {"mc_secant": sum(out_t["strict_sweeps"]),
                     "mc_secant_skip": 0}

    ids, chan_d, q0_d, d0_d, qlat_d, gages_d = _setup(nts)
    ref, _ = _run_engine(ids, chan_d, q0_d, d0_d, qlat_d, gages_d, nts, DT,
                         short=False)
    assert_strict_f64(out_t["flowveldepth"], np.asarray(ref["flowveldepth"]))
    assert_strict_f64(out_t["nudge"], np.asarray(ref["nudge"]))
    for f in ("q", "depth", "res_elev", "lastobs_val", "lastobs_time"):
        assert_strict_f64(getattr(out_t["state"], f),
                          np.asarray(getattr(ref["state"], f)), f)


def _chain(n, seed, dtype):
    """``test_stepped.py``'s 64-segment chain parameters."""
    rng = np.random.default_rng(seed)
    conn = {i: [i + 1] for i in range(1, n)}
    conn[n] = []
    topo = from_connections(conn)
    chan = dict(dx=rng.uniform(500, 3000, n), bw=rng.uniform(2, 20, n),
                tw=rng.uniform(25, 60, n), twcc=rng.uniform(80, 200, n),
                n=np.full(n, 0.055), ncc=np.full(n, 0.11),
                cs=rng.uniform(0.3, 1.5, n), s0=rng.uniform(0.001, 0.02, n))
    return topo, {k: v.astype(dtype) for k, v in chan.items()}, rng


def test_strict_accel_zero_forcing_stays_zero():
    """``test_stepped.py:223-254``: zero forcing and a zero state through
    the accelerated driver stay exactly zero (the measured gain is 0/0 on
    every lane and must fall back to the analytic one)."""
    n = 64
    topo, chan, _ = _chain(n, 2, np.float32)
    z = np.zeros(n, np.float32)
    cfg = jeng.RoutingConfig(dt=DT, nts=4, qts_subdivisions=2,
                             strict_accel=True, kernel="pallas", **STRICT)
    lp = [np.ones(1, np.float32)] * 9
    out_t, out_j = _run_both(topo, chan, lp, cfg, z, z,
                             np.zeros(1, np.float32),
                             np.zeros((2, n), np.float32), np.float32)
    fvd = out_t["flowveldepth"]
    assert np.isfinite(fvd).all()
    np.testing.assert_array_equal(fvd[:, :, 0], 0.0)
    np.testing.assert_array_equal(fvd, np.asarray(out_j["flowveldepth"]))
    assert out_t["strict_sweeps"] == out_j["strict_sweeps"]


def test_strict_floor_converges_large_flows_f32():
    """``test_stepped.py:186-220``: f32 flows of ~1e6 m3/s converge by the
    dtype floor 4 eps max|q|, well short of the sweep cap."""
    n = 64
    topo, chan, rng = _chain(n, 9, np.float32)
    q0 = rng.uniform(8e5, 1.2e6, n).astype(np.float32)
    d0 = rng.uniform(40.0, 60.0, n).astype(np.float32)
    qlat = rng.uniform(10.0, 100.0, (2, n)).astype(np.float32)
    cfg = jeng.RoutingConfig(dt=DT, nts=4, qts_subdivisions=2,
                             kernel="pallas", **STRICT)
    lp = [np.ones(1, np.float32)] * 9
    out_t, out_j = _run_both(topo, chan, lp, cfg, q0, d0,
                             np.zeros(1, np.float32), qlat, np.float32)
    assert np.isfinite(out_t["flowveldepth"]).all()
    sweeps = out_t["strict_sweeps"]
    assert len(sweeps) == 4
    assert all(s < cfg.strict_max_sweeps for s in sweeps), sweeps
    assert_strict_f32(out_t["flowveldepth"], np.asarray(out_j["flowveldepth"]))


def test_strict_typed_reservoir_da_vs_oracle():
    """``test_engine_reservoir_da.py:187-330`` through the port's strict
    driver: USGS-hybrid, RFC and Great-Lake reservoirs read current-step
    inflows, against ``simulate_reference(assume_short_ts=False)``."""
    nts = 48
    rng = np.random.default_rng(77)
    conn, lakes = trd.CONN, copy.deepcopy(trd.LAKES)
    ids = sorted(conn)
    chan = {i: dict(dx=float(rng.uniform(800, 2500)),
                    bw=float(rng.uniform(3, 15)),
                    tw=float(rng.uniform(20, 50)),
                    twcc=float(rng.uniform(70, 160)), n=0.05, ncc=0.1,
                    cs=float(rng.uniform(0.4, 1.2)),
                    s0=float(rng.uniform(0.002, 0.015))) for i in ids}
    q0 = {i: float(rng.uniform(1, 4)) for i in ids}
    depth0 = {i: float(rng.uniform(0.1, 0.6)) for i in ids}
    for lk, p in lakes.items():
        q0[lk] = 2.0
        depth0[lk] = p["elev0"]
    qlat = {i: rng.uniform(0.2, 2.0, nts // 4) for i in ids}
    n_hobs = 30
    hobs_time = np.arange(n_hobs) * 900.0
    hobs = rng.uniform(3, 12, n_hobs)
    hobs[8:14] = np.nan
    lakes[901].update(obs=hobs, obs_time=hobs_time)
    n_counts = 40
    lakes[902].update(series=rng.uniform(5, 25, n_counts),
                      total_counts=n_counts, use_rfc=True, da_step=3600.0,
                      persist_seconds=11 * 86400.0, ts_idx0=2)
    n_gobs = 20
    lakes[903].update(obs=rng.uniform(800, 1200, n_gobs),
                      obs_time=np.arange(n_gobs) * 3600.0, month_idx=7,
                      climatology=rng.uniform(500, 900, 12))
    fvd_ref, _ = simulate_reference(conn, chan, q0, depth0, qlat, nts, DT,
                                    qts_subdivisions=4, assume_short_ts=False,
                                    reservoirs=lakes, gages=None)

    topo = from_connections(conn, reservoir_ids=list(lakes))
    perm = [int(i) for i in topo.ids]
    f64 = dict(dtype=torch.float64)

    def t(a, **kw):
        return torch.as_tensor(np.asarray(a), **(kw or f64))

    cp = teng.ChannelParams.from_arrays(
        device="cpu", dtype=torch.float64,
        **{k: [chan[i][k] if i not in lakes else 1.0 for i in perm]
           for k in teng.ChannelParams._fields})
    slots = [perm[r] for r in topo.reservoir_rows]
    n_res = len(slots)
    keys = ("area", "max_depth", "orifice_area", "orifice_coeff",
            "orifice_elev", "weir_coeff", "weir_elev", "weir_length",
            "dam_length")
    lp = LevelpoolParams(*[t([lakes[lk][k] for lk in slots]) for k in keys])
    wtypes = [lakes[lk]["wbody_type"] for lk in slots]
    h_obs = np.full((n_res, n_hobs), np.nan)
    rfc_series = np.zeros((n_res, n_counts))
    rfc_counts = np.zeros(n_res, np.int32)
    rfc_use = np.zeros(n_res, bool)
    rfc_ts0 = np.zeros(n_res, np.int32)
    g_obs = np.full((n_res, n_gobs), np.nan)
    g_time = np.zeros((n_res, n_gobs))
    g_clim = np.zeros((n_res, 12))
    for s, lk in enumerate(slots):
        p = lakes[lk]
        if p["wbody_type"] in (2, 3):
            h_obs[s] = p["obs"]
        elif p["wbody_type"] in (4, 5):
            rfc_series[s] = p["series"]
            rfc_counts[s] = p["total_counts"]
            rfc_use[s] = p["use_rfc"]
            rfc_ts0[s] = p["ts_idx0"]
        elif p["wbody_type"] == 6:
            g_obs[s], g_time[s], g_clim[s] = (p["obs"], p["obs_time"],
                                              p["climatology"])
    nan_r, zero_r = t(np.full(n_res, np.nan)), t(np.zeros(n_res))
    res_da = teng.ReservoirDAData(
        wbody_type=t(wtypes, dtype=torch.int32), hybrid_obs=t(h_obs),
        hybrid_obs_time=t(hobs_time),
        hybrid_state0=HybridDAState(nan_r, zero_r, zero_r, zero_r),
        rfc_series=t(rfc_series), rfc_counts=t(rfc_counts),
        rfc_use=t(rfc_use, dtype=torch.bool),
        rfc_timestep=t(np.full(n_res, 3600.0)),
        rfc_persist_seconds=t(np.full(n_res, 11 * 86400.0)),
        rfc_state0=RfcDAState(t(rfc_ts0, dtype=torch.int32), zero_r),
        gl_obs=t(g_obs), gl_obs_time=t(g_time), gl_climatology=t(g_clim),
        gl_state0=GreatLakesDAState(nan_r, zero_r, zero_r),
        month_idx=t(np.full(nts + 1, 7), dtype=torch.int32))
    qlat_arr = np.stack([[qlat[i][c] for i in perm]
                         for c in range(nts // 4)])
    cfg = teng.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=4, **STRICT)
    out = teng.route_stepped(
        teng.network_arrays_from_topology(topo, device="cpu"), cp, lp, cfg,
        t([q0[i] for i in perm]), t([depth0[i] for i in perm]),
        t([lakes[lk]["elev0"] for lk in slots]), t(qlat_arr), None, res_da)
    fvd = out["flowveldepth"].numpy()
    assert all(s < cfg.strict_max_sweeps for s in out["strict_sweeps"])
    for node in conn:
        np.testing.assert_allclose(fvd[:, topo.index_of[node], :],
                                   fvd_ref[node][1:, :], rtol=1e-7,
                                   atol=1e-9, err_msg=f"node {node}")


@pytest.mark.parametrize("flag", [1, "true"])
def test_strict_block_skip_truthy_values(flag):
    """``strict_block_skip`` as a YAML file may give it: 1 and "true" turn
    the skip on (the JAX driver's ``is True`` test treats them as off,
    ``engine.py:1345``); "auto" stays off."""
    n = 1024
    topo, chan, rng = _chain(n, 0, np.float64)
    net = teng.network_arrays_from_topology(topo, device="cpu")
    cp = teng.ChannelParams.from_arrays(device="cpu", dtype=torch.float64,
                                        **chan)
    lp = LevelpoolParams(*[torch.ones(1, dtype=torch.float64)] * 9)
    state = [torch.as_tensor(rng.uniform(lo, hi, n))
             for lo, hi in ((0.5, 5.0), (0.05, 0.8))]
    qlat = torch.as_tensor(rng.uniform(0.1, 2.0, (1, n)))
    calls = {}
    for v in (flag, "auto"):
        cfg = teng.RoutingConfig(dt=DT, nts=2, strict_tol=1e-4,
                                 strict_block_skip=v, **STRICT)
        calls[v] = teng.route_stepped(
            net, cp, lp, cfg, *state, torch.zeros(1, dtype=torch.float64),
            qlat)["strict_mc_calls"]
    assert calls[flag]["mc_secant_skip"] > 0
    assert calls["auto"]["mc_secant_skip"] == 0

"""Port parity for ``route()`` (``troute_torch/routing/engine.py``): its
three step forms (short, fixed point, level scan) against the JAX
``route()`` on the same numbers, carried over by ``troute_torch.convert``,
and the level scan against the scalar reference simulator.

Tolerances: f64 rtol 1e-9, atol 1e-10 on ``flowveldepth``, ``nudge`` and
the final state, on all but 1e-3 of the values (at least one), and rel
1e-6 on all (``assert_f64`` says why).  f32: relative difference median <= 1e-6, p95 <= 1e-5,
max <= 5e-2 (``tests/test_torch_engine.py``'s bar: JAX and PyTorch round
``pow`` differently, and rare f32 secant path flips are legitimate).  The
port's chunked and unchunked level scans agree to 1e-12; against
``tests/reference_network.py`` the bar is ``tests/test_engine.py:143``'s,
rtol 1e-8, atol 1e-10.  The fixed-point forms stop on ``strict_tol``; at
the default 1e-9 an ulp of difference can end a step one sweep earlier on
one side and move flows by ~1e-7, so they run at 1e-12 here, where both
sides reach the fixed point.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from troute_tpu.network.topology import build_topology, from_connections
from troute_tpu.ops.levelpool import LevelpoolParams as JLevelpoolParams
from troute_tpu.ops.reservoir_da import (GreatLakesDAState, HybridDAState,
                                         RfcDAState)
from troute_tpu.routing import engine as jeng
from troute_torch import convert, synthetic
from troute_torch.network.topology import build_topology as t_build_topology
from troute_torch.routing import engine as teng

from reference_network import simulate_reference
from test_engine import CONN, LAKE, LAKE_ID, _run_engine, _setup
from test_torch_engine import LAKE_KEYS

torch.set_num_threads(1)

DT = 300.0
N, N_RES, N_GAGE, NTS = 400, 6, 8, 6


def assert_f64(got, want, what=""):
    """rtol 1e-9, atol 1e-10, on all but 1e-3 of the values (and at least
    one), and rel diff <= 1e-6 everywhere: XLA's and PyTorch's f64 ``pow``
    differ in the last bit on some headwater lanes, and a few lanes of
    the secant amplify that ~1e3 per step (``chip_smoke.py``'s
    ``check_f64_network`` says the same of two CPU implementations)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    off = ~np.isclose(got, want, rtol=1e-9, atol=1e-10, equal_nan=True)
    assert off.sum() <= max(1, 1e-3 * off.size), (what, int(off.sum()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10,
                               err_msg=what)


def assert_f32_bar(got, want, what=""):
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), ~ok, err_msg=what)
    rel = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1e-6)
    assert np.median(rel) <= 1e-6, what
    assert np.percentile(rel, 95) <= 1e-5, what
    assert rel.max() <= 5e-2, what


def _reservoir_da(n_res, nts, rng):
    """Typed reservoir DA inputs as NumPy: USGS and USACE hybrid, CONUS
    and Alaska RFC, Great Lake and plain level-pool lanes in turn."""
    types = np.array([2, 4, 6, 1, 3, 5], np.int32)[np.arange(n_res) % 6]
    n_hobs, n_counts, n_gobs = 30, 40, 20
    hobs = rng.uniform(3, 12, (n_res, n_hobs))
    hobs[:, 8:14] = np.nan
    hobs[~np.isin(types, (2, 3))] = np.nan
    rfc = np.where(np.isin(types, (4, 5))[:, None],
                   rng.uniform(5, 25, (n_res, n_counts)), 0.0)
    gobs = np.where((types == 6)[:, None],
                    rng.uniform(800, 1200, (n_res, n_gobs)), np.nan)
    gobs[:, 3:6] = np.nan
    z = np.zeros(n_res)
    return dict(
        wbody_type=types, hybrid_obs=hobs,
        hybrid_obs_time=np.arange(n_hobs) * 900.0,
        hybrid_state0=HybridDAState(np.full(n_res, np.nan), z, z, z),
        rfc_series=rfc,
        rfc_counts=np.where(np.isin(types, (4, 5)), n_counts,
                            0).astype(np.int32),
        rfc_use=np.isin(types, (4, 5)),
        rfc_timestep=np.full(n_res, 3600.0),
        rfc_persist_seconds=np.full(n_res, 11 * 86400.0),
        rfc_state0=RfcDAState(np.full(n_res, 2, np.int32), z),
        gl_obs=gobs, gl_obs_time=np.tile(np.arange(n_gobs) * 3600.0,
                                         (n_res, 1)),
        gl_climatology=np.where((types == 6)[:, None],
                                rng.uniform(500, 900, (n_res, 12)), 0.0),
        gl_state0=GreatLakesDAState(np.full(n_res, np.nan), z, z),
        month_idx=np.full(nts + 1, 7, np.int32))


def _case(seed=4):
    """A synthetic network of N segments with N_RES level-pool reservoirs
    (typed reservoir DA) and N_GAGE gages, as NumPy inputs."""
    ids, down = synthetic.synthetic_conus(n=N, n_basins=10)
    rng = np.random.default_rng(seed)
    has_up = np.isin(ids, down)
    nt = np.zeros(N, np.int8)
    nt[rng.choice(np.flatnonzero(has_up), N_RES, replace=False)] = 1
    chan = synthetic.channel_params(N, rng)
    lp = [rng.uniform(1.0, 3.0, N_RES)] + [np.full(N_RES, v) for v in (
        12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 10.0)]
    q0 = rng.uniform(0.5, 5.0, N)
    d0 = rng.uniform(0.05, 0.8, N)
    elev0 = rng.uniform(10.0, 11.5, N_RES)
    topo = build_topology(ids, down, node_type=nt)
    d0[topo.reservoir_rows] = elev0
    qlat = rng.uniform(0.1, 2.0, (2, N))
    obs = rng.uniform(1.0, 10.0, (NTS + 1, N_GAGE))
    obs[rng.random(obs.shape) < 0.4] = np.nan
    gage = dict(rows=rng.choice(np.flatnonzero(nt == 0), N_GAGE,
                                replace=False),
                obs=obs, lastobs_val=rng.uniform(1, 10, N_GAGE),
                lastobs_time=-rng.uniform(0, 3600, N_GAGE))
    return dict(ids=ids, down=down, nt=nt, topo=topo, chan=chan, lp=lp,
                q0=q0, d0=d0, elev0=elev0, qlat=qlat, gage=gage,
                res_da=_reservoir_da(N_RES, NTS, rng))


def _jax_inputs(case, np_dtype):
    def a(x, dt=np_dtype):
        return jnp.asarray(np.asarray(x), dt)

    jda = jeng.GageDA(rows=a(case["gage"]["rows"], jnp.int32),
                      obs=a(case["gage"]["obs"]),
                      lastobs_val=a(case["gage"]["lastobs_val"]),
                      lastobs_time=a(case["gage"]["lastobs_time"]),
                      decay_coeff=120.0)
    rd = {}
    for k, v in case["res_da"].items():
        if isinstance(v, tuple):
            rd[k] = type(v)(*[a(f, None if np.asarray(f).dtype.kind == "i"
                                else np_dtype) for f in v])
        elif np.asarray(v).dtype.kind in "ib":
            rd[k] = jnp.asarray(v)
        else:
            rd[k] = a(v)
    jres = jeng.ReservoirDAData(**rd)
    jchan = jeng.ChannelParams(**{k: a(v) for k, v in case["chan"].items()})
    jlp = JLevelpoolParams(*[a(v) for v in case["lp"]])
    arrs = [a(case[k]) for k in ("q0", "d0", "elev0", "qlat")]
    return jchan, jlp, arrs, jda, jres


def _run_both(case, cfg, np_dtype, chunk=None, port_net=False):
    """JAX ``route()`` and the port's on the same numbers; both outputs as
    NumPy dicts (the JAX state carried over through ``convert``)."""
    need = not cfg.assume_short_ts and not cfg.strict_iterative
    jnet = jeng.network_arrays_from_topology(case["topo"], need_levels=need,
                                             level_chunk_width=chunk)
    jchan, jlp, arrs, jda, jres = _jax_inputs(case, np_dtype)
    out_j = jeng.route(jnet, jchan, jlp, cfg, *arrs, jda, jres)

    kw = dict(device="cpu",
              dtype=torch.from_numpy(np.zeros(0, np_dtype)).dtype)
    if port_net:
        topo = t_build_topology(case["ids"], case["down"],
                                node_type=case["nt"])
        net = teng.network_arrays_from_topology(
            topo, device="cpu", need_levels=need, level_chunk_width=chunk)
    else:
        net = convert.from_network_arrays(jnet, device="cpu")
    out_t = teng.route(
        net, convert.from_channel_params(jchan, **kw),
        convert.from_levelpool_params(jlp, **kw), cfg,
        *[convert._t(x, **kw) for x in arrs], convert.from_gage_da(jda, **kw),
        convert.from_reservoir_da(jres, **kw))
    st_j = convert.from_routing_state(out_j["state"], **kw)
    return convert.to_numpy(out_t), dict(
        flowveldepth=np.asarray(out_j["flowveldepth"]),
        nudge=np.asarray(out_j["nudge"]), state=convert.to_numpy(st_j))


def _compare(out_t, out_j, check):
    check(out_t["flowveldepth"], out_j["flowveldepth"], "fvd")
    check(out_t["nudge"], out_j["nudge"], "nudge")
    st_t, st_j = out_t["state"], out_j["state"]
    for f in ("q", "depth", "res_elev", "lastobs_val", "lastobs_time"):
        check(getattr(st_t, f), getattr(st_j, f), f)
    for name in ("hybrid", "rfc", "gl"):
        for a, b in zip(getattr(st_t, name), getattr(st_j, name)):
            check(a, b, name)


@pytest.fixture(scope="module")
def case():
    return _case()


FORMS = {"short": dict(assume_short_ts=True),
         "fixed_point": dict(strict_iterative=True, strict_tol=1e-12),
         "fixed_point_accel": dict(strict_iterative=True, strict_accel=True,
                                   strict_tol=1e-12),
         "level_scan": dict()}


@pytest.mark.parametrize("form", list(FORMS))
def test_route_f64_vs_jax(case, form):
    """Every step form with reservoirs (typed DA) and gages, f64."""
    cfg = teng.RoutingConfig(dt=DT, nts=NTS, qts_subdivisions=3,
                             **FORMS[form])
    out_t, out_j = _run_both(case, cfg, np.float64)
    _compare(out_t, out_j, assert_f64)
    assert np.isfinite(out_t["flowveldepth"]).all()
    if form == "level_scan":
        n_rows = int((case["topo"].level_nodes >= 0).any(axis=1).sum())
        assert out_t["mc_calls"] == NTS * n_rows
    elif form.startswith("fixed"):
        assert out_t["mc_calls"] == sum(out_t["strict_sweeps"]) + NTS


@pytest.fixture(scope="module")
def warm_case(case):
    """``case`` from the state after 12 short f64 steps of the JAX
    ``route()``: from the cold random start an f32 secant is ill
    conditioned, and within-step coupling carries a lane's last-bit
    difference down the levels (25% on a lane at level 4 of step 1),
    where production strict runs start from a routed state."""
    cfg = teng.RoutingConfig(dt=DT, nts=12, qts_subdivisions=6,
                             assume_short_ts=True)
    jnet = jeng.network_arrays_from_topology(case["topo"], need_levels=False)
    jchan, jlp, arrs, jda, jres = _jax_inputs(case, np.float64)
    st = jeng.route(jnet, jchan, jlp, cfg, *arrs, jda, jres)["state"]
    warm = dict(case, q0=np.asarray(st.q), d0=np.asarray(st.depth),
                elev0=np.asarray(st.res_elev))
    warm["gage"] = dict(case["gage"], lastobs_val=np.asarray(st.lastobs_val),
                        lastobs_time=np.asarray(st.lastobs_time) - 12 * DT)
    return warm


@pytest.mark.parametrize("form", ["short", "level_scan"])
def test_route_f32_vs_jax(warm_case, form):
    cfg = teng.RoutingConfig(dt=DT, nts=NTS, qts_subdivisions=3,
                             **FORMS[form])
    out_t, out_j = _run_both(warm_case, cfg, np.float32)
    _compare(out_t, out_j, assert_f32_bar)


@pytest.mark.parametrize("chunk", [7, 64])
def test_level_scan_chunked_vs_jax_and_unchunked(case, chunk):
    """Level rows split into chunks (``level_chunks``) on the port's own
    topology: the JAX chunked scan to the f64 bar, the port's unchunked
    scan to 1e-12."""
    cfg = teng.RoutingConfig(dt=DT, nts=NTS, qts_subdivisions=3,
                             return_courant=True)
    out_t, out_j = _run_both(case, cfg, np.float64, chunk=chunk,
                             port_net=True)
    _compare(out_t, out_j, assert_f64)
    whole, _ = _run_both(case, cfg, np.float64, port_net=True)
    for k in ("flowveldepth", "nudge", "courant"):
        np.testing.assert_allclose(out_t[k], whole[k], rtol=1e-12,
                                   atol=1e-12, err_msg=k)
    assert out_t["mc_calls"] > whole["mc_calls"]


def test_level_scan_vs_reference():
    """The level scan on ``tests/test_engine.py``'s network (a lake and a
    gage) against ``simulate_reference(assume_short_ts=False)``."""
    nts = 36
    ids, chan, q0, depth0, qlat, gages = _setup(nts)
    fvd_ref, nudge_ref = simulate_reference(
        CONN, chan, q0, depth0, qlat, nts, DT, qts_subdivisions=4,
        assume_short_ts=False, reservoirs={LAKE_ID: LAKE},
        gages=dict(gages, lastobs_val=list(gages["lastobs_val"]),
                   lastobs_time=list(gages["lastobs_time"])))
    topo = from_connections(CONN, reservoir_ids=[LAKE_ID])
    perm = [int(i) for i in topo.ids]
    idx = {i: k for k, i in enumerate(perm)}
    f64 = dict(device="cpu", dtype=torch.float64)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64))

    cp = teng.ChannelParams.from_arrays(
        **f64, **{k: [chan[i][k] if i != LAKE_ID else 1.0 for i in perm]
                  for k in teng.ChannelParams._fields})
    lp = teng.LevelpoolParams(*[t([LAKE[k]]) for k in LAKE_KEYS])
    da = teng.GageDA(rows=torch.tensor([idx[r] for r in gages["rows"]]),
                     obs=t(gages["obs"]), lastobs_val=t(gages["lastobs_val"]),
                     lastobs_time=t(gages["lastobs_time"]),
                     decay_coeff=gages["decay_coeff"])
    qlat_arr = np.stack([[qlat[i][c] for i in perm]
                         for c in range(nts // 4)])
    cfg = teng.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=4)
    net = teng.network_arrays_from_topology(topo, device="cpu",
                                            need_levels=True)
    out = teng.route(net, cp, lp, cfg, t([q0[i] for i in perm]),
                     t([depth0[i] for i in perm]), t([LAKE["elev0"]]),
                     t(qlat_arr), da)
    fvd = out["flowveldepth"].numpy()
    for node in CONN:
        np.testing.assert_allclose(fvd[:, idx[node], :],
                                   fvd_ref[node][1:, :], rtol=1e-8,
                                   atol=1e-10, err_msg=f"node {node}")
    np.testing.assert_allclose(out["nudge"].numpy(), nudge_ref[1:],
                               rtol=1e-8, atol=1e-10)
    # and the JAX level scan on the same network
    want, _ = _run_engine(ids, chan, q0, depth0, qlat, gages, nts, DT,
                          short=False)
    assert_f64(fvd, np.asarray(want["flowveldepth"]))


def test_level_scan_needs_levels_and_route_stepped_refuses(case):
    cfg = teng.RoutingConfig(dt=DT, nts=1)
    net = teng.network_arrays_from_topology(case["topo"], device="cpu")
    z = torch.zeros(N, dtype=torch.float64)
    args = (net, None, None, cfg, z, z, z, z[None])
    with pytest.raises(ValueError, match="level_nodes"):
        teng.route(*args)
    with pytest.raises(ValueError, match=r"route\(\)"):
        teng.route_stepped(*args)


def test_level_schedule_matches_jax(case):
    """``level_nodes`` and ``level_chunks`` as the JAX topology has them;
    chunks never wider than the widest level."""
    topo_t = t_build_topology(case["ids"], case["down"], node_type=case["nt"])
    np.testing.assert_array_equal(topo_t.level_nodes, case["topo"].level_nodes)
    widest = case["topo"].level_nodes.shape[1]
    for w in (5, 64, 10 ** 6):
        got = topo_t.level_chunks(w)
        assert got.shape[1] == min(w, widest)
        flat = got[got >= 0]
        want = case["topo"].level_chunks(w)
        np.testing.assert_array_equal(flat, want[want >= 0])

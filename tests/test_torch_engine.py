"""Port parity for the short-timestep engine
(``troute_torch/routing/engine.py``): gage nudging and ``route_stepped``
against the JAX ``route_stepped`` (Pallas kernel in interpret mode), with
both sides fed identical numbers through ``troute_torch.convert``.

Tolerances: f64 rtol 1e-9, atol 1e-12 on every output (the reference's
per-lane bar; these networks carry benign flows, where the MC secant is
well-conditioned).  f32: rel diff median <= 1e-6, p95 <= 1e-5, max <=
5e-2 (``test_muskingum.py:140-142``, median relaxed from 0 because JAX
and torch use different libm rounding; rare f32 secant path flips are
legitimate).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from troute_tpu.network.topology import build_topology, from_connections
from troute_tpu.ops.levelpool import LevelpoolParams as JLevelpoolParams
from troute_tpu.routing import engine as jeng
from troute_torch import convert
from troute_torch.routing import engine as teng

from test_engine import CONN, LAKE, LAKE_ID, _setup

torch.set_num_threads(1)

DT = 300.0
LAKE_KEYS = ("area", "max_depth", "orifice_area", "orifice_coeff",
             "orifice_elev", "weir_coeff", "weir_elev", "weir_length",
             "dam_length")


def assert_f64(got, want, what=""):
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                               err_msg=what)


def assert_f32_bar(got, want, what=""):
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert np.median(rel) <= 1e-6, what
    assert np.percentile(rel, 95) <= 1e-5, what
    assert rel.max() <= 5e-2, what


def _run_both(topo, chan, lp, cfg, q0, d0, elev0, qlat, np_dtype,
              gages=None, res_da=None, port_net=False):
    """JAX ``route_stepped`` and the port's on the same numbers; returns
    both outputs as NumPy dicts."""
    jnet = jeng.network_arrays_from_topology(topo, need_levels=False)
    jchan = jeng.ChannelParams(**{k: jnp.asarray(v, np_dtype)
                                  for k, v in chan.items()})
    jlp = JLevelpoolParams(*[jnp.asarray(v, np_dtype) for v in lp])
    jda_g = None
    if gages is not None:
        jda_g = jeng.GageDA(
            rows=jnp.asarray(gages["rows"], jnp.int32),
            obs=jnp.asarray(gages["obs"], np_dtype),
            lastobs_val=jnp.asarray(gages["lastobs_val"], np_dtype),
            lastobs_time=jnp.asarray(gages["lastobs_time"], np_dtype),
            decay_coeff=gages["decay_coeff"])
    arrs = [jnp.asarray(a, np_dtype) for a in (q0, d0, elev0, qlat)]
    out_j = jeng.route_stepped(jnet, jchan, jlp, cfg, *arrs, jda_g, res_da)

    kw = dict(device="cpu", dtype=torch.from_numpy(np.zeros(0,
                                                            np_dtype)).dtype)
    net = (teng.network_arrays_from_topology(topo, device="cpu") if port_net
           else convert.from_network_arrays(jnet, device="cpu"))
    out_t = teng.route_stepped(
        net, convert.from_channel_params(jchan, **kw),
        convert.from_levelpool_params(jlp, **kw), cfg,
        *[convert._t(a, **kw) for a in arrs],
        None if jda_g is None else convert.from_gage_da(jda_g, **kw),
        None if res_da is None else convert.from_reservoir_da(res_da, **kw))
    return convert.to_numpy(out_t), out_j


def _compare(out_t, out_j, check, courant=False):
    check(out_t["flowveldepth"], np.asarray(out_j["flowveldepth"]), "fvd")
    check(out_t["nudge"], np.asarray(out_j["nudge"]), "nudge")
    if courant:
        check(out_t["courant"], np.asarray(out_j["courant"]), "courant")
    else:
        assert "courant" not in out_t
    # the JAX final state, carried over as the port would take it to
    # start the next window
    dtype = torch.from_numpy(out_t["flowveldepth"]).dtype
    st_j = convert.to_numpy(convert.from_routing_state(
        out_j["state"], device="cpu", dtype=dtype))
    st_t = out_t["state"]
    for f in ("q", "depth", "res_elev", "lastobs_val", "lastobs_time"):
        check(getattr(st_t, f), getattr(st_j, f), f)
    for name in ("hybrid", "rfc", "gl"):
        s_t, s_j = getattr(st_t, name), getattr(st_j, name)
        assert (s_t is None) == (s_j is None), name
        if s_t is not None:
            for a, b in zip(s_t, s_j):
                assert a.dtype == b.dtype, name
                check(a, b, name)


def _conn_case(nts):
    ids, chan_d, q0, depth0, qlat, gages = _setup(nts)
    topo = from_connections(CONN, reservoir_ids=[LAKE_ID])
    perm = [int(i) for i in topo.ids]
    idx = {i: k for k, i in enumerate(perm)}
    chan = {k: np.array([chan_d[i][k] if i != LAKE_ID else 1.0
                         for i in perm])
            for k in ("dx", "bw", "tw", "twcc", "n", "ncc", "cs", "s0")}
    lp = [np.array([LAKE[k]]) for k in LAKE_KEYS]
    n_cols = len(next(iter(qlat.values())))
    qlat_arr = np.stack([np.array([qlat[i][c] for i in perm])
                         for c in range(n_cols)])
    gages = dict(gages, rows=[idx[r] for r in gages["rows"]])
    return (topo, chan, lp, np.array([q0[i] for i in perm]),
            np.array([depth0[i] for i in perm]), np.array([LAKE["elev0"]]),
            qlat_arr, gages)


def test_apply_nudging_vs_jax():
    """Gage lanes with an observation, with a decaying last observation,
    and with neither (NaN lastobs: the model value stays, nothing
    downstream turns NaN)."""
    q = np.linspace(1.0, 20.0, 12)
    rows = np.array([2, 5, 7, 9])
    obs_t = np.array([4.0, np.nan, np.nan, 9.5])
    lo_val = np.array([3.0, 6.0, np.nan, np.nan])
    lo_time = np.array([-600.0, -1800.0, np.nan, -300.0])
    t_s = 900.0
    jda_g = jeng.GageDA(rows=jnp.asarray(rows, jnp.int32),
                        obs=jnp.asarray(obs_t[None]),
                        lastobs_val=jnp.asarray(lo_val),
                        lastobs_time=jnp.asarray(lo_time), decay_coeff=120.0)
    want = jeng._apply_nudging(jnp.asarray(q), jnp.asarray(t_s), jda_g,
                               jnp.asarray(lo_val), jnp.asarray(lo_time),
                               jnp.asarray(obs_t))
    tda_g = convert.from_gage_da(jda_g, device="cpu", dtype=torch.float64)
    got = teng._apply_nudging(torch.as_tensor(q), tda_g.rows, t_s,
                              tda_g.decay_coeff, torch.as_tensor(lo_val),
                              torch.as_tensor(lo_time),
                              torch.as_tensor(obs_t))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert np.isfinite(got[0].numpy()).all()
    assert float(got[0][7]) == q[7] and float(got[1][2]) == 0.0


@pytest.mark.parametrize("return_courant", [False, True])
def test_route_stepped_conn_f64(return_courant):
    """Lake + gage network, 30 steps (past the JAX 24-step window; the
    last qlat column is read past the table and clamps), f64."""
    nts = 30
    topo, chan, lp, q0, d0, elev0, qlat, gages = _conn_case(nts)
    cfg = jeng.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=4,
                             assume_short_ts=True,
                             return_courant=return_courant)
    out_t, out_j = _run_both(topo, chan, lp, cfg, q0, d0, elev0, qlat,
                             np.float64, gages=gages)
    assert out_t["flowveldepth"].shape == (nts, topo.n_nodes, 3)
    assert out_t["nudge"].shape == (nts, 1)
    _compare(out_t, out_j, assert_f64, courant=return_courant)
    assert np.isfinite(out_t["flowveldepth"]).all()


def test_route_stepped_typed_reservoir_da_f64():
    """Hybrid persistence, RFC and Great Lakes reservoirs in one chain
    (mirrors ``test_stepped.py:115``) plus a gage whose obs table ends
    before the run and a month table shorter than the run, f64."""
    nts = 10
    conn = {1: [2], 2: [901], 901: [3], 3: [902], 902: [4], 4: [903],
            903: [5], 5: [6], 6: []}
    topo = from_connections(conn, reservoir_ids=[901, 902, 903])
    n = topo.n_nodes
    rng = np.random.default_rng(3)
    chan = dict(dx=rng.uniform(800, 2500, n), bw=rng.uniform(3, 15, n),
                tw=rng.uniform(20, 50, n), twcc=rng.uniform(70, 160, n),
                n=np.full(n, 0.05), ncc=np.full(n, 0.1),
                cs=rng.uniform(0.4, 1.2, n), s0=rng.uniform(0.002, 0.015, n))
    lp = [np.full(3, v) for v in (2.0, 12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0,
                                  10.0)]
    hobs = np.full((3, 30), np.nan)
    hobs[0, 0:20] = rng.uniform(3, 9, 20)
    series = rng.uniform(-2, 12, (3, 12))
    gobs = rng.uniform(2, 8, (3, 10))
    gobs[:, 3:5] = np.nan
    f64 = jnp.float64
    res_da = jeng.ReservoirDAData.inactive(3, nts, f64)._replace(
        wbody_type=jnp.asarray([2, 4, 6], jnp.int32),
        hybrid_obs=jnp.asarray(hobs),
        hybrid_obs_time=jnp.asarray(np.arange(30) * 900.0),
        rfc_series=jnp.asarray(series),
        rfc_counts=jnp.full(3, 12, jnp.int32),
        rfc_use=jnp.ones(3, bool),
        rfc_timestep=jnp.full(3, 3600.0),
        rfc_persist_seconds=jnp.full(3, 86400.0),
        gl_obs=jnp.asarray(gobs),
        gl_obs_time=jnp.asarray(np.tile(np.arange(10) * 1800.0, (3, 1))),
        gl_climatology=jnp.asarray(rng.uniform(3, 6, (3, 12))),
        month_idx=jnp.asarray([4, 4, 5, 5, 6], jnp.int32))
    q0 = rng.uniform(1, 4, n)
    d0 = rng.uniform(0.1, 0.5, n)
    res_rows = topo.reservoir_rows
    d0[res_rows] = 10.5
    elev0 = np.full(3, 10.5)
    qlat = rng.uniform(0.2, 2.0, (8, n))
    obs = np.full((7, 1), np.nan)
    obs[2:6, 0] = rng.uniform(2, 6, 4)
    gages = dict(rows=[topo.index_of[5]], obs=obs, lastobs_val=[np.nan],
                 lastobs_time=[np.nan], decay_coeff=120.0)
    cfg = jeng.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=4,
                             assume_short_ts=True)
    out_t, out_j = _run_both(topo, chan, lp, cfg, q0, d0, elev0, qlat,
                             np.float64, gages=gages, res_da=res_da)
    _compare(out_t, out_j, assert_f64)
    assert np.isfinite(out_t["flowveldepth"]).all()


def test_route_stepped_synthetic_conus_f32():
    """A CONUS-statistics synthetic network (4000 nodes) with 8 level-pool
    reservoirs and 16 gages, 12 steps in f32; the port builds its own
    network tensors and plan."""
    n, nts = 4000, 12
    ids, down = bench.synthetic_conus(n=n, n_basins=40)
    rng = np.random.default_rng(17)
    has_up = np.zeros(n, bool)
    has_up[np.searchsorted(ids, down[down > 0])] = True
    nt = np.zeros(n, np.int8)
    nt[rng.choice(np.flatnonzero(has_up), 8, replace=False)] = 1
    topo = build_topology(ids, down, node_type=nt)
    chan = bench.channel_params(n, rng)
    res_rows = topo.reservoir_rows
    lp = [rng.uniform(1.0, 3.0, 8), np.full(8, 12.0), np.full(8, 1.2),
          np.full(8, 0.1), np.full(8, 8.0), np.full(8, 0.4),
          np.full(8, 11.0), np.full(8, 12.0), np.full(8, 10.0)]
    q0 = rng.uniform(0.5, 5.0, n)
    d0 = rng.uniform(0.05, 0.8, n)
    elev0 = rng.uniform(10.0, 11.5, 8)
    d0[res_rows] = elev0
    qlat = rng.uniform(0.1, 2.0, (3, n))
    mc_rows = np.flatnonzero(nt == 0)
    obs = rng.uniform(1.0, 10.0, (nts + 1, 16))
    obs[rng.random(obs.shape) < 0.4] = np.nan
    gages = dict(rows=rng.choice(mc_rows, 16, replace=False), obs=obs,
                 lastobs_val=rng.uniform(1, 10, 16),
                 lastobs_time=-rng.uniform(0, 3600, 16), decay_coeff=120.0)
    cfg = jeng.RoutingConfig(dt=DT, nts=nts, qts_subdivisions=4,
                             assume_short_ts=True)
    out_t, out_j = _run_both(topo, chan, lp, cfg, q0, d0, elev0, qlat,
                             np.float32, gages=gages, port_net=True)
    assert out_t["flowveldepth"].dtype == np.float32
    _compare(out_t, out_j, assert_f32_bar)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reservoir_da_inactive_matches_jax(dtype):
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    got = teng.ReservoirDAData.inactive(3, 10, device="cpu", dtype=dtype)
    want = convert.from_reservoir_da(
        jeng.ReservoirDAData.inactive(3, 10, np_dtype), device="cpu",
        dtype=dtype)
    flat_g = convert.to_numpy(got)
    flat_w = convert.to_numpy(want)
    for f in teng.ReservoirDAData._fields:
        g, w = getattr(flat_g, f), getattr(flat_w, f)
        for a, b in (zip(g, w) if isinstance(g, tuple) else [(g, w)]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("with_da", [False, True])
def test_one_short_step_lakes_unchanged_on_cpu(with_da):
    """The short step's lake block on the CPU, which the row form of the
    level-pool wrapper now computes: the same arrays, bit for bit, as the
    block computed before, which gathered ``quc[res_rows]``, ran
    ``_reservoirs`` (the plain level pool and, with ``res_da``, the typed
    DA) and scattered the outflow and depth out of place into the MC
    result; no kernel launch."""
    from troute_torch.network.topology import build_topology_postorder
    from troute_torch.ops import levelpool_cuda
    from troute_torch.ops.levelpool import LevelpoolParams
    n, n_res, f32 = 3000, 24, torch.float32
    ids, down = bench.synthetic_conus(n=n, n_basins=20)
    rng = np.random.default_rng(8)
    nt = np.zeros(n, np.int8)
    nt[rng.choice(np.flatnonzero(np.isin(ids, down)), n_res,
                  replace=False)] = 1
    net = teng.network_arrays_from_topology(
        build_topology_postorder(ids, down, node_type=nt), device="cpu")
    chan = teng.ChannelParams.from_arrays(
        device="cpu", dtype=f32, **bench.channel_params(n, rng))
    up, is_res = net.upstream, net.is_reservoir
    wb = np.stack([rng.uniform(1.0, 3.0, n_res), rng.uniform(11.0, 12.5, n_res),
                   *[np.full(n_res, v) for v in (1.2, 0.1, 8.0, 0.4, 11.0,
                                                 12.0)],
                   np.full(n_res, 0.9)], axis=1)
    lp = LevelpoolParams.from_array(wb, device="cpu", dtype=f32)

    def t(a):
        return torch.as_tensor(a, dtype=f32)

    q, depth, ql = (t(rng.uniform(lo, hi, n)) for lo, hi in (
        (0.5, 5.0), (0.05, 0.8), (0.1, 2.0)))
    res_elev = t(rng.uniform(7.5, 12.5, n_res))
    res_da, states, month_i = None, None, None
    if with_da:
        res_da = teng.ReservoirDAData.inactive(
            n_res, 2, device="cpu", dtype=f32)._replace(
            wbody_type=torch.as_tensor(np.where(np.arange(n_res) % 3, 1, 2),
                                       dtype=torch.int32),
            hybrid_obs=t(rng.uniform(1.0, 30.0, (n_res, 8))),
            hybrid_obs_time=t(np.arange(8) * 900.0 - 3600.0))
        states = (res_da.hybrid_state0, res_da.rfc_state0,
                  res_da.gl_state0)
        month_i = 0
    empty = torch.zeros(0, dtype=f32)
    no_gages = torch.zeros(0, dtype=torch.int64)
    before = levelpool_cuda.LAUNCHES
    got = teng._one_short_step(
        q, depth, res_elev, empty, empty, ql, empty, DT, up, chan, lp,
        is_res, net.res_rows, no_gages, 120.0, DT, res_da=res_da,
        da_states=states, month_i=month_i, uplan=net.uplan, want_raw=True)
    assert levelpool_cuda.LAUNCHES == before
    raw = got[-1]
    quc = teng._upstream_sum_stepped(q, up, net.uplan)
    outflow, elev, d_scat, want_states = teng._reservoirs(
        lp, res_da, res_elev, quc[net.res_rows], states, DT, month_i, DT)
    want_q = torch.where(is_res, q, raw.qdc).index_put((net.res_rows,),
                                                       outflow)
    want_d = torch.where(is_res, depth, raw.depthc).index_put(
        (net.res_rows,), d_scat)
    assert torch.equal(got[0], want_q) and torch.equal(got[2], want_d)
    assert torch.equal(got[3], elev)
    assert torch.equal(got[1], torch.where(is_res, 0.0, raw.velc))
    if with_da:
        assert not torch.equal(outflow, teng._reservoirs(
            lp, None, res_elev, quc[net.res_rows], None, DT, None, DT)[0])
        for g, w in zip(got[7], want_states):
            for a, b in zip(g, w):
                assert torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0))


def test_strict_mode_not_ported():
    """The level-scan strict form is ``route()``'s
    (``tests/test_torch_route.py``): ``route_stepped`` refuses it and
    names ``route()``, as the JAX driver refuses it; the strict
    fixed-point form is tested in ``test_torch_strict.py``."""
    cfg = teng.RoutingConfig(dt=DT, nts=2, assume_short_ts=False)
    z = torch.zeros(1, dtype=torch.float64)
    with pytest.raises(ValueError, match=r"route\(\)"):
        teng.route_stepped(None, None, None, cfg, z, z, z, z[None])

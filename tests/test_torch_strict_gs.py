"""Port parity for the Gauss-Seidel strict sweeps of ``route_stepped``
(``troute_torch/routing/engine.py:_strict_gs_sweeps``), mirroring
``tests/test_strict_gs.py``: the port's GS against the JAX package's GS
(the same iteration), and against the port's own Jacobi sweeps (another
splitting with the same fixed point), with reservoir DA and nudging.

Both sides get the same NumPy inputs from a seed, carried over with
``troute_torch.convert``; the JAX side runs its Pallas kernel in
interpret mode, as the JAX tests do.

Tolerances:
- GS against JAX GS, f64: rtol 1e-9, atol 1e-9 (the strict driver's bar,
  ``test_engine.py:241-261``), with equal per-step sweep counts; f32:
  ``test_torch_skip.assert_strict_f32``;
- GS against Jacobi: rtol 2e-6 with atol 5e-7 (f64) or 1e-6 (f32), the
  JAX package's bar for the two splittings (``test_strict_gs.py``): the
  sweep delta under-bounds the residual by the coupling's contraction
  factor, so iterates of different splittings agree to ~1e-6 at the 1e-9
  sweep tolerance.
"""

import numpy as np
import torch

import jax.numpy as jnp

from troute_tpu.network.topology import from_connections
from troute_tpu.ops.levelpool import LevelpoolParams as JLevelpoolParams
from troute_tpu.routing import engine as jeng
from troute_torch import convert
from troute_torch.network.topology import build_topology_postorder
from troute_torch.routing import engine as teng

from test_torch_skip import assert_strict_f32

torch.set_num_threads(1)

DT = 300.0


def _chan(n, rng):
    return dict(dx=rng.uniform(800, 2500, n), bw=rng.uniform(3, 15, n),
                tw=rng.uniform(20, 50, n), twcc=rng.uniform(70, 160, n),
                n=np.full(n, 0.05), ncc=np.full(n, 0.1),
                cs=rng.uniform(0.4, 1.2, n), s0=rng.uniform(0.002, 0.015, n))


def _both(topo, chan, lp, cfg, arrs, np_dtype, da=None, res_da=None):
    """The JAX driver and the port's on one configuration; the port's
    output as NumPy, the JAX output as it is."""
    jnet = jeng.network_arrays_from_topology(topo, need_levels=False)
    jchan = jeng.ChannelParams(**{k: jnp.asarray(v, np_dtype)
                                  for k, v in chan.items()})
    jlp = JLevelpoolParams(*[jnp.asarray(v, np_dtype) for v in lp])
    jarrs = [jnp.asarray(a, np_dtype) for a in arrs]
    kw = dict(device="cpu",
              dtype=torch.from_numpy(np.zeros(0, np_dtype)).dtype)
    out_t = teng.route_stepped(
        convert.from_network_arrays(jnet, device="cpu"),
        convert.from_channel_params(jchan, **kw),
        convert.from_levelpool_params(jlp, **kw), cfg,
        *[convert._t(a, **kw) for a in jarrs],
        None if da is None else convert.from_gage_da(da, **kw),
        None if res_da is None else convert.from_reservoir_da(res_da, **kw))
    out_j = (jeng.route_stepped(jnet, jchan, jlp, cfg, *jarrs, da, res_da)
             if cfg.strict_gs else None)
    return convert.to_numpy(out_t), out_j


def _gs_ran(out, cfg):
    """GS chunks call the MC solve once per column, so the calls exceed
    the sweeps (the commit sweep is one call)."""
    return out["strict_mc_calls"]["mc_secant"] > sum(out["strict_sweeps"])


def test_gs_deep_chain_f64():
    """600-node chain, f64: the port's GS equals JAX's GS, reaches the
    fixed point of the port's Jacobi sweeps, and takes fewer sweeps."""
    n, nts = 600, 4
    conn = {i: [i + 1] for i in range(1, n)}
    conn[n] = []
    topo = from_connections(conn)
    rng = np.random.default_rng(2)
    chan = _chan(n, rng)
    lp = [np.ones(1)] * 9
    arrs = [rng.uniform(0.5, 5.0, n), rng.uniform(0.05, 0.8, n),
            np.zeros(1), rng.uniform(0.1, 2.0, (2, n))]
    base = dict(dt=DT, nts=nts, qts_subdivisions=2, assume_short_ts=False,
                strict_iterative=True, kernel="pallas")
    cfg_gs = jeng.RoutingConfig(**base, strict_gs=True)
    gs, gs_j = _both(topo, chan, lp, cfg_gs, arrs, np.float64)
    assert _gs_ran(gs, cfg_gs)
    np.testing.assert_allclose(gs["flowveldepth"],
                               np.asarray(gs_j["flowveldepth"]), rtol=1e-9,
                               atol=1e-9)
    assert gs["strict_sweeps"] == gs_j["strict_sweeps"]
    jac, _ = _both(topo, chan, lp, jeng.RoutingConfig(**base), arrs,
                   np.float64)
    np.testing.assert_allclose(gs["flowveldepth"], jac["flowveldepth"],
                               rtol=2e-6, atol=5e-7)
    assert sum(gs["strict_sweeps"]) < sum(jac["strict_sweeps"]), \
        (gs["strict_sweeps"], jac["strict_sweeps"])


def test_gs_reservoir_da_and_nudging_f32():
    """Junction network with a USGS-hybrid reservoir and two gages, f32:
    the port's GS against JAX's GS and against the port's Jacobi sweeps,
    in flows, nudges, the reservoir's persisted outflow and elevation.
    The rows are in post-order, so every band shift is positive and GS
    applies: in ``from_connections``' row order the plan has the shift -9,
    and the JAX test's GS configuration runs Jacobi sweeps."""
    nts = 6
    f32 = jnp.float32
    conn = {1: [2], 2: [901], 901: [3], 3: [7], 4: [5], 5: [7],
            7: [8], 8: [9], 9: [],
            20: [21], 21: [22], 22: []}
    by_conn = from_connections(conn, reservoir_ids=[901])
    down = by_conn.ids[np.maximum(by_conn.downstream, 0)]
    topo = build_topology_postorder(
        by_conn.ids, np.where(by_conn.downstream >= 0, down, 0),
        node_type=by_conn.node_type)
    n = topo.n_nodes
    rng = np.random.default_rng(5)
    chan = _chan(n, rng)
    lp = [np.asarray([v]) for v in (2.0, 12.0, 1.2, 0.1, 8.0, 0.4, 11.0,
                                    12.0, 10.0)]
    hobs = np.full((1, 30), np.nan)
    hobs[0, 2:20] = rng.uniform(3, 9, 18)
    res_da = jeng.ReservoirDAData.inactive(1, nts, f32)._replace(
        wbody_type=jnp.asarray([2], jnp.int32),
        hybrid_obs=jnp.asarray(hobs, f32),
        hybrid_obs_time=jnp.asarray(np.arange(30) * 900.0, f32))
    obs = np.full((nts + 1, 2), np.nan)
    obs[2:5, 0] = rng.uniform(3, 6, 3)
    obs[1:, 1] = rng.uniform(1, 2, nts)
    da = jeng.GageDA(
        rows=jnp.asarray([topo.index_of[8], topo.index_of[21]]),
        obs=jnp.asarray(obs, f32), lastobs_val=jnp.asarray([np.nan, 2.5], f32),
        lastobs_time=jnp.asarray([0.0, -900.0], f32), decay_coeff=120.0)
    d0 = rng.uniform(0.1, 0.5, n)
    q0 = rng.uniform(1, 4, n)
    d0[topo.index_of[901]] = 10.5
    arrs = [q0, d0, np.asarray([10.5]), rng.uniform(0.2, 2.0, (3, n))]
    base = dict(dt=DT, nts=nts, qts_subdivisions=2, assume_short_ts=False,
                strict_iterative=True, kernel="pallas")
    cfg_gs = jeng.RoutingConfig(**base, strict_gs=True)
    gs, gs_j = _both(topo, chan, lp, cfg_gs, arrs, np.float32, da, res_da)
    assert _gs_ran(gs, cfg_gs)
    assert_strict_f32(gs["flowveldepth"], np.asarray(gs_j["flowveldepth"]))
    jac, _ = _both(topo, chan, lp, jeng.RoutingConfig(**base), arrs,
                   np.float32, da, res_da)
    pairs = [(gs["flowveldepth"], jac["flowveldepth"],
              np.asarray(gs_j["flowveldepth"])),
             (gs["nudge"], jac["nudge"], np.asarray(gs_j["nudge"])),
             (gs["state"].hybrid.persisted_outflow,
              jac["state"].hybrid.persisted_outflow,
              np.asarray(gs_j["state"].hybrid.persisted_outflow)),
             (gs["state"].res_elev, jac["state"].res_elev,
              np.asarray(gs_j["state"].res_elev))]
    for got, other, want in pairs:
        np.testing.assert_allclose(got, other, rtol=2e-6, atol=1e-6)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

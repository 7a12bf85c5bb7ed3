"""Inputs shared by ``test_torch_sharded.py`` and
``test_torch_sharded_strict.py``: the networks of ``test_sharded.py``
(made from a seed), their JAX objects carried into the forms the port's
ranks take (plain NumPy: a rank imports no JAX), and the port's
single-device references."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import torch

from test_sharded import ELEV0, LAKE_ROWVALS, _global_setup
from test_torch_partition import port_topology
from troute_torch import convert
from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.routing import engine as tengine
from troute_tpu.network.topology import from_connections
from troute_tpu.routing.engine import GageDA, ReservoirDAData

DT = 300.0
DTYPES = {"float32": torch.float32, "float64": torch.float64}
JDTYPES = {"float32": jnp.float32, "float64": jnp.float64}


def conn_case(gages=(3, 8, 22), nts=24, seed=5):
    """``test_sharded``'s two basins and lake mainstem with gages."""
    topo, chan, q0, depth0, qlat, lake_row = _global_setup()
    rng = np.random.default_rng(seed)
    rows = np.asarray([topo.index_of[g] for g in gages])
    obs = np.full((nts + 1, rows.size), np.nan)
    obs[2:10, 0] = rng.uniform(5, 9, 8)
    if rows.size > 1:
        obs[5:20, 1] = rng.uniform(2, 4, 15)
    obs[1:, -1] = rng.uniform(1, 2, nts)
    lov = np.full(rows.size, np.nan)
    lot = np.zeros(rows.size)
    lov[min(1, rows.size - 1)] = 3.0
    lot[min(1, rows.size - 1)] = -600.0
    return SimpleNamespace(
        topo=topo, chan=chan, q0=q0, depth0=depth0, qlat=qlat,
        params=LAKE_ROWVALS, elev0=np.array([ELEV0]),
        gage=dict(rows=rows, obs=obs, lastobs_val=lov, lastobs_time=lot,
                  decay_coeff=120.0), res_da=None)


def da_case(nts=24, typed=True, params=None, elev=(10.5, 40.0)):
    """``test_sharded``'s network of two lakes with typed reservoir DA
    (USGS persistence and a Great Lake) and two gages."""
    conn = {1: [2], 2: [901], 901: [3], 3: [4], 4: [],
            10: [903], 903: [11], 11: [4]}
    rng = np.random.default_rng(9)
    topo = from_connections(conn, reservoir_ids=[901, 903])
    n = topo.n_nodes
    chan = dict(
        dx=rng.uniform(500, 3000, n), bw=rng.uniform(2, 20, n),
        tw=rng.uniform(25, 60, n), twcc=rng.uniform(80, 200, n),
        n=np.full(n, 0.055), ncc=np.full(n, 0.11),
        cs=rng.uniform(0.3, 1.5, n), s0=rng.uniform(0.001, 0.02, n))
    q0 = rng.uniform(0.5, 5.0, n)
    depth0 = rng.uniform(0.05, 0.8, n)
    if params is None:
        params = np.array([[2.0, 12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 10.0],
                           [500.0, 50.0, 1.0, 0.1, 10.0, 0.4, 45.0, 100.0,
                            10.0]])
    lake_rows = {int(topo.ids[r]): int(r) for r in topo.reservoir_rows}
    for lk, e in zip((901, 903), elev):
        q0[lake_rows[lk]] = 2.0
        depth0[lake_rows[lk]] = e
    elev0 = np.array([depth0[r] for r in topo.reservoir_rows])
    qlat = rng.uniform(0.1, 2.0, (6, n))
    n_res = topo.reservoir_rows.size
    hobs = np.full((n_res, 20), np.nan)
    gobs = np.full((n_res, 20), np.nan)
    gtime = np.zeros((n_res, 20))
    clim = np.zeros((n_res, 12))
    wt = np.ones(n_res, np.int32)
    for s, r in enumerate(topo.reservoir_rows):
        if not typed:
            continue
        if int(topo.ids[r]) == 901:
            wt[s] = 2
            hobs[s] = rng.uniform(3, 9, 20)
        else:
            wt[s] = 6
            gobs[s] = rng.uniform(800, 1200, 20)
            gtime[s] = np.arange(20) * 3600.0
            clim[s] = rng.uniform(500, 900, 12)
    res_da = None
    if typed:
        res_da = ReservoirDAData.inactive(n_res, nts, jnp.float64)._replace(
            wbody_type=jnp.asarray(wt),
            hybrid_obs=jnp.asarray(hobs),
            hybrid_obs_time=jnp.asarray(np.arange(20) * 900.0),
            gl_obs=jnp.asarray(gobs), gl_obs_time=jnp.asarray(gtime),
            gl_climatology=jnp.asarray(clim),
            month_idx=jnp.full(nts + 1, 7, jnp.int32))
    rows = np.asarray([topo.index_of[3], topo.index_of[11]])
    obs = np.full((nts + 1, 2), np.nan)
    obs[2:12, 0] = rng.uniform(5, 9, 10)
    obs[1:, 1] = rng.uniform(1, 2, nts)
    return SimpleNamespace(
        topo=topo, chan=chan, q0=q0, depth0=depth0, qlat=qlat,
        params=params, elev0=elev0,
        gage=dict(rows=rows, obs=obs, lastobs_val=np.array([np.nan, 3.0]),
                  lastobs_time=np.array([0.0, -600.0]), decay_coeff=120.0),
        res_da=res_da)


def jax_gage_da(case, dtype="float64"):
    g = case.gage
    jd = JDTYPES[dtype]
    return GageDA(rows=jnp.asarray(g["rows"]), obs=jnp.asarray(g["obs"], jd),
                  lastobs_val=jnp.asarray(g["lastobs_val"], jd),
                  lastobs_time=jnp.asarray(g["lastobs_time"], jd),
                  decay_coeff=g["decay_coeff"])


def np_fields(nt):
    """A JAX NamedTuple's fields as NumPy arrays (nested NamedTuples as
    lists of their fields' arrays, floats and tuples kept)."""
    out = {}
    for f, v in nt._asdict().items():
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out[f] = [np.asarray(a) for a in v]
        elif isinstance(v, (float, int, tuple)) or v is None:
            out[f] = v
        else:
            out[f] = np.asarray(v)
    return out


def global_case(case, world, cfg, dtype="float64", assignment=None,
                exchange="neighbor", with_da=True):
    """A ``ranks.run_cases`` "global" case (``route_sharded_global``)."""
    return dict(
        kind="global", world=world, dtype=dtype,
        topo=port_topology(case.topo), chan=case.chan,
        res_params=case.params, cfg=cfg, q0=case.q0, depth0=case.depth0,
        elev0=case.elev0, qlat=case.qlat,
        da=case.gage if with_da else None,
        res_da=(None if case.res_da is None or not with_da
                else np_fields(case.res_da)),
        assignment=assignment, exchange=exchange)


def port_route(case, cfg, dtype="float64", with_da=True):
    """The port's single-device ``route_stepped`` on the CPU."""
    td = DTYPES[dtype]
    topo = port_topology(case.topo)
    net = tengine.network_arrays_from_topology(topo, device="cpu")
    da = res_da = None
    if with_da:
        da = convert.from_gage_da(jax_gage_da(case, dtype), device="cpu",
                                  dtype=td)
        if case.res_da is not None:
            res_da = convert.from_reservoir_da(case.res_da, device="cpu",
                                               dtype=td)
    out = tengine.route_stepped(
        net, tengine.ChannelParams.from_arrays(device="cpu", dtype=td,
                                               **case.chan),
        LevelpoolParams.from_array(case.params, device="cpu", dtype=td), cfg,
        torch.as_tensor(case.q0, dtype=td), torch.as_tensor(case.depth0,
                                                            dtype=td),
        torch.as_tensor(case.elev0, dtype=td),
        torch.as_tensor(case.qlat, dtype=td), da, res_da)
    return convert.to_numpy(out)


def port_cfg(**kw):
    kw.setdefault("qts_subdivisions", 4)
    return tengine.RoutingConfig(dt=DT, **kw)


def assert_state_close(got: dict, want, **tol):
    """A rank's gathered ``RoutingState`` (a dict of arrays) against a
    reference state (NamedTuple of arrays or tensors)."""
    for f in ("q", "depth", "res_elev", "lastobs_val", "lastobs_time"):
        np.testing.assert_allclose(got[f], np.asarray(getattr(want, f)),
                                   err_msg=f, **tol)
    for f in ("hybrid", "rfc", "gl"):
        w = getattr(want, f)
        if w is None:
            assert got[f] is None, f
            continue
        for g, x in zip(got[f], w):
            np.testing.assert_allclose(np.asarray(g), np.asarray(x),
                                       err_msg=f, **tol)

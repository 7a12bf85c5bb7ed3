"""The port's sharded short-timestep routing (``troute_torch/parallel``)
in gloo groups of 1, 2 and 4 CPU ranks against the port's single-device
``route_stepped`` and the JAX package's sharded engines on
``Mesh(jax.devices()[:D])``, on ``test_sharded.py``'s networks with the
same partitions.

One spawn of 4 ranks (``parallel/ranks.py:run_cases``) runs every case of
this file; each case runs on the ranks [0, D) of its world size D.

Tolerances:
* world size 1 against ``route_stepped``: bit for bit, in float64 and
  float32 (the same steps on the same padded rows, in the same order);
* world sizes 2 and 4 with cut edges, float64: against ``route_stepped``
  and against JAX's ``route_sharded`` and ``route_sharded_stepped`` at
  the JAX package's own bar between its drivers, rtol 1e-9 and atol
  1e-12 (``test_sharded_stepped.py:61-62``): boundary rows add their
  upstream terms in another order, and the two packages take ``pow``
  from different libraries; the full contract of ``route_sharded_global``
  (flows, nudges, states) against JAX's ``route()`` at the same bar;
* the ``"neighbor"`` exchange against ``"allgather"``: bit for bit;
* float32 at world size 2: the f32 bar of ``test_torch_cli.py`` against
  ``route_stepped`` and against JAX's sharded engine;
* every rank solved MC with B1's plain version (no CUDA launch) and
  imported no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sharded_cases import (DT, JDTYPES, assert_state_close, conn_case,
                           da_case, global_case, jax_gage_da, np_fields,
                           port_cfg, port_route)
from test_torch_cli import f32_bar
from test_torch_partition import port_topology
from troute_torch.parallel import ranks
from troute_torch.parallel.group import spawn_ranks
from troute_torch.parallel.partition import balanced_assignment
from troute_tpu.ops.levelpool import LevelpoolParams as JLevelpoolParams
from troute_tpu.parallel.partition import gather_from_shards, partition_network
from troute_tpu.parallel.sharded_engine import (
    build_sharded_inputs, route_sharded, route_sharded_global,
    shard_reservoir_da)
from troute_tpu.parallel.stepped_engine import route_sharded_stepped
from troute_tpu.routing.engine import (ChannelParams, RoutingConfig,
                                       network_arrays_from_topology, route)

SHORT = dict(rtol=1e-9, atol=1e-12)
NTS = 12
NTS_STEPPED = 4   # JAX's stepped driver runs Pallas interpreted on the CPU


def forced(topo, d):
    return (np.arange(topo.n_nodes) % d).astype(np.int32)


def jax_inputs(case, d, nts, dtype="float64", with_res_da=False):
    """JAX's partition (forced cuts), sharded inputs and reservoir DA."""
    part = partition_network(case.topo, d, forced(case.topo, d))
    elev = {int(r): float(case.elev0[i])
            for i, r in enumerate(case.topo.reservoir_rows)}
    g = case.gage
    inp = build_sharded_inputs(
        part, case.topo, case.chan, case.params, case.q0, case.depth0, elev,
        case.qlat, dtype=JDTYPES[dtype], gage_rows=g["rows"],
        gage_obs=g["obs"][:nts + 1], gage_lo_val=g["lastobs_val"],
        gage_lo_time=g["lastobs_time"])
    rda = None
    if with_res_da:
        rda = shard_reservoir_da(part, case.topo, case.res_da,
                                 np.asarray(inp.res_slots),
                                 dtype=JDTYPES[dtype])
    return part, inp, rda


def shard_case(case, d, nts, dtype="float64", with_res_da=False, **kw):
    part, inp, rda = jax_inputs(case, d, nts, dtype, with_res_da)
    return dict(kind="shard", world=d, dtype=dtype, inp=np_fields(inp),
                res_da=None if rda is None else np_fields(rda), dt=DT,
                nts=nts, qts=4, band_shifts=part.band_shifts, **kw)


def regional_case(n=1200, n_basins=4, seed=2):
    """A regional network (``synthetic.regional_network``) with 12
    level-pool lakes and 12 gages."""
    from troute_torch import synthetic
    from troute_tpu.network.topology import build_topology
    from types import SimpleNamespace
    ids, down = synthetic.regional_network(n, n_basins, seed)
    rng = np.random.default_rng(seed)
    nt = np.zeros(n, np.int8)
    nt[rng.choice(np.flatnonzero(np.isin(ids, down)), 12, replace=False)] = 1
    topo = build_topology(ids, down, node_type=nt, row_order="postorder")
    chan = dict(dx=rng.uniform(500, 3000, n), bw=rng.uniform(2, 20, n),
                tw=rng.uniform(25, 60, n), twcc=rng.uniform(80, 200, n),
                n=np.full(n, 0.055), ncc=np.full(n, 0.11),
                cs=rng.uniform(0.3, 1.5, n), s0=rng.uniform(0.001, 0.02, n))
    res = topo.reservoir_rows
    params = np.repeat([[1.5, 12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 10.0]],
                       res.size, axis=0)
    q0, depth0 = rng.uniform(0.5, 5.0, n), rng.uniform(0.05, 0.8, n)
    elev0 = rng.uniform(10.0, 11.5, res.size)
    depth0[res] = elev0
    rows = rng.choice(np.flatnonzero(nt == 0), 12, replace=False)
    obs = rng.uniform(1.0, 10.0, (NTS + 1, 12))
    obs[rng.random(obs.shape) < 0.4] = np.nan
    return SimpleNamespace(
        topo=topo, chan=chan, q0=q0, depth0=depth0,
        qlat=rng.uniform(0.1, 2.0, (6, n)), params=params, elev0=elev0,
        gage=dict(rows=rows, obs=obs, lastobs_val=rng.uniform(1, 10, 12),
                  lastobs_time=-rng.uniform(0, 3600, 12), decay_coeff=120.0),
        res_da=None)


def regional_cut(case, d):
    """``balanced_assignment`` with one more cut in the middle of a basin:
    the first rank's last 40 rows move to the second rank."""
    a = balanced_assignment(port_topology(case.topo), d)
    last = np.flatnonzero(a == 0)[-40:]
    a[last] = 1
    return a


@pytest.fixture(scope="module")
def setup():
    """Every case, and one spawn of 4 gloo ranks that runs them."""
    conn, dac, reg = conn_case(), da_case(), regional_case()
    short = port_cfg(nts=NTS, assume_short_ts=True)
    cases = {}
    for dtype in ("float64", "float32"):
        cases[f"w1_conn_{dtype}"] = global_case(conn, 1, short, dtype)
        cases[f"w1_regional_{dtype}"] = global_case(reg, 1, short, dtype)
    for d in (2, 4):
        cases[f"w{d}_conn"] = global_case(conn, d, short,
                                          assignment=forced(conn.topo, d))
        cases[f"w{d}_regional"] = global_case(reg, d, short,
                                              assignment=regional_cut(reg, d))
        cases[f"w{d}_shard"] = shard_case(conn, d, NTS_STEPPED,
                                          with_res_da=False)
    cases["w4_conn_allgather"] = global_case(
        conn, 4, short, assignment=forced(conn.topo, 4), exchange="allgather")
    cases["w4_contract"] = global_case(dac, 4, short,
                                       assignment=forced(dac.topo, 4))
    cases["w4_resda_shard"] = shard_case(dac, 4, NTS_STEPPED,
                                         with_res_da=True)
    cases["w2_conn_float32"] = global_case(conn, 2, short, "float32",
                                           assignment=forced(conn.topo, 2))
    # a lake above its maximum storage, and the builder's ninth parameter
    # column (the initial fill fraction, 0.5) where the JAX plan reads the
    # dam length (ROADMAP C4)
    params = np.array([[2.0, 10.0, 1.2, 0.1, 8.0, 0.4, 9.0, 12.0, 0.5],
                       [500.0, 50.0, 1.0, 0.1, 10.0, 0.4, 45.0, 100.0,
                        0.5]])
    over = da_case(typed=False, params=params, elev=(10.8, 40.0))
    cases["w2_dam"] = global_case(over, 2, port_cfg(nts=12,
                                                    assume_short_ts=True),
                                  assignment=forced(over.topo, 2),
                                  with_da=False)
    names = list(cases)
    out = spawn_ranks(ranks.run_cases, 4, args=(list(cases.values()),),
                      timeout=240)
    res = {k: [r["cases"][i] for r in out] for i, k in enumerate(names)}
    return dict(cases=cases, res=res, procs=out, conn=conn, dac=dac,
                reg=reg, over=over, short=short)


@pytest.mark.parametrize("net", ["conn", "regional"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_world_size_1_equals_route_stepped_bit_for_bit(setup, net, dtype):
    case = setup[net if net == "conn" else "reg"]
    got = setup["res"][f"w1_{net}_{dtype}"][0]
    want = port_route(case, setup["short"], dtype)
    np.testing.assert_array_equal(got["fvd"], want["flowveldepth"])
    np.testing.assert_array_equal(got["nudge"], want["nudge"])
    for f in ("q", "depth", "res_elev", "lastobs_val", "lastobs_time"):
        np.testing.assert_array_equal(got["state"][f],
                                      getattr(want["state"], f), err_msg=f)
    assert got["mc_calls"] == NTS and got["cut_edges"] == 0


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("net", ["conn", "regional"])
def test_cut_edges_match_route_stepped(setup, d, net):
    case = setup[net if net == "conn" else "reg"]
    outs = setup["res"][f"w{d}_{net}"]
    want = port_route(case, setup["short"])
    for r in range(d):
        np.testing.assert_array_equal(outs[r]["fvd"], outs[0]["fvd"])
    got = outs[0]
    assert got["cut_edges"] > 0
    np.testing.assert_allclose(got["fvd"], want["flowveldepth"], **SHORT)
    np.testing.assert_allclose(got["nudge"], want["nudge"], **SHORT)
    assert_state_close(got["state"], want["state"], **SHORT)


@pytest.mark.parametrize("d", [2, 4])
def test_cut_edges_match_jax_route_sharded(setup, d):
    """The gathered run against JAX's in-scan ``route_sharded`` on the
    same forced partition (24 steps, gages)."""
    conn = setup["conn"]
    part, inp, _ = jax_inputs(conn, d, NTS)
    mesh = Mesh(np.array(jax.devices()[:d]), ("basin",))
    res = route_sharded(mesh, inp, DT, NTS, qts_subdivisions=4,
                        band_shifts=part.band_shifts)
    want = gather_from_shards(part, np.asarray(res.fvd).transpose(
        0, 2, 1, 3)).transpose(1, 0, 2)
    got = setup["res"][f"w{d}_conn"][0]
    np.testing.assert_allclose(got["fvd"], want, **SHORT)
    assert got["rounds"] == part.perm_pairs.shape[0]


@pytest.mark.parametrize("d", [2, 4])
def test_shard_matches_jax_stepped(setup, d):
    """Each rank's shard, fed JAX's sharded inputs
    (``convert.from_sharded_inputs``), against JAX's
    ``route_sharded_stepped`` rank by rank: flows, nudges, last obs."""
    conn = setup["conn"]
    part, inp, _ = jax_inputs(conn, d, NTS_STEPPED)
    mesh = Mesh(np.array(jax.devices()[:d]), ("basin",))
    want = route_sharded_stepped(mesh, inp, DT, NTS_STEPPED,
                                 qts_subdivisions=4,
                                 band_shifts=part.band_shifts, k_steps=2)
    outs = setup["res"][f"w{d}_shard"]
    for r in range(d):
        for f in ("fvd", "nudge", "q", "depth", "lo_val", "lo_time"):
            np.testing.assert_allclose(outs[r][f],
                                       np.asarray(getattr(want, f))[r],
                                       err_msg=f"rank {r} {f}", **SHORT)
        has_b = bool((part.boundary_rows[r] >= 0).any())
        assert outs[r]["mc_calls"] == NTS_STEPPED * (1 + has_b)


def test_neighbor_equals_allgather(setup):
    nb, ag = setup["res"]["w4_conn"], setup["res"]["w4_conn_allgather"]
    for r in range(4):
        np.testing.assert_array_equal(nb[r]["fvd"], ag[r]["fvd"])
        np.testing.assert_array_equal(nb[r]["nudge"], ag[r]["nudge"])
        for f in ("q", "depth", "res_elev", "lastobs_val", "lastobs_time"):
            np.testing.assert_array_equal(nb[r]["state"][f],
                                          ag[r]["state"][f])


def test_typed_reservoir_da_matches_jax_stepped(setup):
    """Typed reservoir DA (persistence and Great Lakes) with gages, 4
    ranks, every node on another rank than its neighbours: rank by rank
    against JAX's ``route_sharded_stepped`` with its sharded DA lanes."""
    dac = setup["dac"]
    part, inp, rda = jax_inputs(dac, 4, NTS_STEPPED, with_res_da=True)
    mesh = Mesh(np.array(jax.devices()[:4]), ("basin",))
    want = route_sharded_stepped(mesh, inp, DT, NTS_STEPPED,
                                 qts_subdivisions=4, res_da=rda,
                                 band_shifts=part.band_shifts, k_steps=2)
    outs = setup["res"]["w4_resda_shard"]
    for r in range(4):
        for f in ("fvd", "nudge", "res_elev", "lo_val"):
            np.testing.assert_allclose(outs[r][f],
                                       np.asarray(getattr(want, f))[r],
                                       err_msg=f"rank {r} {f}", **SHORT)
        for s in ("hyb", "rfc", "gl"):
            for g, w in zip(outs[r][s], getattr(want, s)):
                np.testing.assert_allclose(np.asarray(g), np.asarray(w)[r],
                                           err_msg=f"rank {r} {s}", **SHORT)


def test_global_contract_matches_jax_route(setup):
    """``route_sharded_global``'s full contract on 4 ranks (typed
    reservoir DA and gages) against JAX's ``route()`` and the port's
    ``route_stepped``: flows, nudges and the final ``RoutingState``."""
    dac = setup["dac"]
    got = setup["res"]["w4_contract"][0]
    jd = jnp.float64
    net = network_arrays_from_topology(dac.topo, need_levels=False)
    cfg = RoutingConfig(dt=DT, nts=NTS, qts_subdivisions=4,
                        assume_short_ts=True)
    ref = route(net, ChannelParams(**{k: jnp.asarray(v, jd)
                                      for k, v in dac.chan.items()}),
                JLevelpoolParams(*[jnp.asarray(dac.params[:, i], jd)
                                   for i in range(9)]), cfg,
                jnp.asarray(dac.q0, jd), jnp.asarray(dac.depth0, jd),
                jnp.asarray(dac.elev0, jd), jnp.asarray(dac.qlat, jd),
                jax_gage_da(dac), dac.res_da)
    np.testing.assert_allclose(got["fvd"], np.asarray(ref["flowveldepth"]),
                               **SHORT)
    np.testing.assert_allclose(got["nudge"], np.asarray(ref["nudge"]),
                               **SHORT)
    assert_state_close(got["state"], ref["state"], **SHORT)
    port = port_route(dac, setup["short"])
    np.testing.assert_allclose(got["fvd"], port["flowveldepth"], **SHORT)
    assert_state_close(got["state"], port["state"], **SHORT)
    for r in range(1, 4):
        np.testing.assert_array_equal(setup["res"]["w4_contract"][r]["fvd"],
                                      got["fvd"])


def test_float32_at_the_f32_bar(setup):
    conn = setup["conn"]
    got = setup["res"]["w2_conn_float32"][0]
    f32_bar(got["fvd"], port_route(conn, setup["short"],
                                   "float32")["flowveldepth"])
    part, inp, _ = jax_inputs(conn, 2, NTS, "float32")
    mesh = Mesh(np.array(jax.devices()[:2]), ("basin",))
    res = route_sharded(mesh, inp, DT, NTS, qts_subdivisions=4,
                        band_shifts=part.band_shifts)
    want = gather_from_shards(part, np.asarray(res.fvd).transpose(
        0, 2, 1, 3)).transpose(1, 0, 2)
    assert got["fvd"].dtype == np.float32
    f32_bar(got["fvd"], want)


def test_dam_length_unlike_jax(setup):
    """A lake above its maximum storage, with the network builder's
    parameter array (ninth column: initial fill fraction 0.5).  The port's
    sharded run equals its single-device run; JAX's sharded run reads the
    fill fraction as the dam length and differs from JAX's ``route()``,
    which uses 10 m (ROADMAP C4)."""
    over = setup["over"]
    cfg_t = setup["cases"]["w2_dam"]["cfg"]
    got = setup["res"]["w2_dam"][0]
    want = port_route(over, cfg_t, with_da=False)
    np.testing.assert_allclose(got["fvd"], want["flowveldepth"], **SHORT)
    lake = over.topo.reservoir_rows[0]
    assert (want["flowveldepth"][:, lake, 2] > over.params[0, 1]).any()
    jd = jnp.float64
    cfg = RoutingConfig(dt=DT, nts=cfg_t.nts, qts_subdivisions=4,
                        assume_short_ts=True)
    mesh = Mesh(np.array(jax.devices()[:2]), ("basin",))
    jax_sh = route_sharded_global(
        mesh, over.topo, over.chan, over.params, cfg, over.q0, over.depth0,
        over.elev0, over.qlat,
        part=partition_network(over.topo, 2, forced(over.topo, 2)),
        dtype=jd)["flowveldepth"]
    net = network_arrays_from_topology(over.topo, need_levels=False)
    jax_one = np.asarray(route(
        net, ChannelParams(**{k: jnp.asarray(v, jd)
                              for k, v in over.chan.items()}),
        JLevelpoolParams.from_array(jnp.asarray(over.params, jd)), cfg,
        jnp.asarray(over.q0, jd), jnp.asarray(over.depth0, jd),
        jnp.asarray(over.elev0, jd), jnp.asarray(over.qlat, jd))[
            "flowveldepth"])
    np.testing.assert_allclose(got["fvd"], jax_one, **SHORT)
    assert not np.allclose(jax_sh, jax_one, rtol=1e-6, atol=1e-9)


def test_ranks_ran_the_plain_solve_and_imported_no_jax(setup):
    """Every rank solved with B1's plain version (the CPU path counts no
    launch) and imported nothing of JAX or the JAX package; a rank's MC
    solves are its steps, plus its steps again where it has boundary
    rows."""
    for r, proc in enumerate(setup["procs"]):
        assert proc["launches"] == 0 and proc["skip_launches"] == 0, r
        assert proc["foreign"] == [], (r, proc["foreign"])
    conn = setup["conn"]
    for d in (2, 4):
        part = partition_network(conn.topo, d, forced(conn.topo, d))
        for r in range(d):
            has_b = bool((part.boundary_rows[r] >= 0).any())
            assert setup["res"][f"w{d}_conn"][r]["mc_calls"] == \
                NTS * (1 + has_b)


"""The port's partition of a network across ranks
(``troute_torch/parallel/partition.py``), its host library functions
(``native.connected_components``, ``native.tree_cut_parts``) and its
sharded plan (``parallel/sharded_engine.py:sharded_plan``) against the JAX
package's.

Everything here is integer, boolean or float64 host arrays built by the
same rules, so every comparison is exact: field for field, dtype
included.  The one difference is deliberate: the port's plan sets the
reservoirs' dam length to 10 m (``LevelpoolParams.from_array``), where
the JAX plan reads a ninth parameter column (ROADMAP C4); the inputs of
the equality test carry 10 m there.
"""

from dataclasses import fields

import numpy as np
import pytest

from test_sharded import CONN, LAKE_ROWVALS
from troute_torch import native, synthetic
from troute_torch.network import topology as ttopo
from troute_torch.parallel import partition as tp
from troute_torch.parallel.sharded_engine import rank_inputs, sharded_plan
from troute_tpu import native as jnative
from troute_tpu.network import topology as jtopo
from troute_tpu.parallel import partition as jp
from troute_tpu.parallel.sharded_engine import build_sharded_inputs


def port_topology(t):
    """The port's ``RoutingTopology`` holding a JAX one's arrays."""
    return ttopo.RoutingTopology(
        ids=np.asarray(t.ids), downstream=np.asarray(t.downstream),
        upstream=np.asarray(t.upstream), level=np.asarray(t.level),
        node_type=np.asarray(t.node_type))


def _regional():
    ids, down = synthetic.regional_network(20_000, 7, 3)
    rng = np.random.default_rng(4)
    nt = np.zeros(ids.size, np.int8)
    nt[rng.choice(np.flatnonzero(np.isin(ids, down)), 30,
                  replace=False)] = 1
    return jtopo.build_topology(ids, down, node_type=nt,
                                row_order="postorder"), (ids, down, nt)


@pytest.fixture(scope="module")
def networks():
    conn = jtopo.from_connections(CONN, reservoir_ids=[900])
    regional, args = _regional()
    port_regional = ttopo.build_topology_postorder(*args[:2],
                                                   node_type=args[2])
    for f in ("ids", "downstream", "upstream", "node_type"):
        np.testing.assert_array_equal(getattr(port_regional, f),
                                      getattr(regional, f))
    return {"conn": (conn, port_topology(conn)),
            "regional": (regional, port_regional)}


def assert_same_partition(got, want):
    for f in fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


def _assignment(kind, jt, pt, n_dev):
    if kind == "basins":
        a, b = jp.greedy_basin_assignment(jt, n_dev), \
            tp.greedy_basin_assignment(pt, n_dev)
    elif kind == "balanced":
        a, b = jp.balanced_assignment(jt, n_dev), \
            tp.balanced_assignment(pt, n_dev)
    else:   # forced mid-basin cuts: every n_dev-th row on one rank
        a = b = (np.arange(jt.n_nodes) % n_dev).astype(np.int32)
    np.testing.assert_array_equal(b, a)
    assert b.dtype == a.dtype
    return a, b


@pytest.mark.parametrize("net", ["conn", "regional"])
@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", ["basins", "balanced", "forced"])
def test_partition_matches_jax(networks, net, n_dev, kind):
    jt, pt = networks[net]
    a, b = _assignment(kind, jt, pt, n_dev)
    want = jp.partition_network(jt, n_dev, a)
    got = tp.partition_network(pt, n_dev, b)
    assert_same_partition(got, want)
    if kind == "basins":
        assert_same_partition(tp.partition_network(pt, n_dev),
                              jp.partition_network(jt, n_dev))
    if kind == "forced" and n_dev > 1:
        assert got.cut_edges > 0
    if kind == "balanced" and net == "regional":
        # a few cuts between ranks, and loads within one part of even
        loads = np.bincount(b, minlength=n_dev)
        assert got.cut_edges <= 2 * n_dev
        assert loads.max() - loads.min() <= -(-jt.n_nodes // (4 * n_dev))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_scatter_gather_round_trip_matches_jax(networks, n_dev):
    jt, pt = networks["regional"]
    a, b = _assignment("balanced", jt, pt, n_dev)
    jpart, tpart = jp.partition_network(jt, n_dev, a), \
        tp.partition_network(pt, n_dev, b)
    x = np.random.default_rng(n_dev).uniform(0, 9, (jt.n_nodes, 3))
    got, want = tp.scatter_to_shards(tpart, x, 1.0), \
        jp.scatter_to_shards(jpart, x, 1.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tp.gather_from_shards(tpart, got), x)
    np.testing.assert_array_equal(tp.gather_from_shards(tpart, got),
                                  jp.gather_from_shards(jpart, want))


@pytest.mark.parametrize("cap", [1, 7, 500, 20_000])
def test_tree_cut_parts_native_and_python_match_jax(networks, cap):
    jt, pt = networks["regional"]
    ds = np.asarray(pt.downstream)
    want = jp._tree_cut_parts_py(np.asarray(jt.downstream), cap)
    np.testing.assert_array_equal(tp._tree_cut_parts_py(ds, cap), want)
    np.testing.assert_array_equal(native.tree_cut_parts(ds, cap), want)
    np.testing.assert_array_equal(jnative.tree_cut_parts(ds, cap), want)
    sizes = np.bincount(want)
    assert sizes.max() <= max(cap, 1) or cap == 1


def test_connected_components_native_and_python(networks):
    """The native labels equal the JAX package's native labels; the
    Python fallback labels the same basins (its labels are root rows)."""
    jt, pt = networks["regional"]
    got = native.connected_components(pt.downstream)
    np.testing.assert_array_equal(got, jnative.connected_components(
        np.asarray(jt.downstream)))
    assert got.dtype == np.int32
    import unittest.mock as mock
    with mock.patch.object(native, "connected_components",
                           lambda ds: None):
        py = tp._components(pt)
    # the same partition into basins: a bijection between labels
    pairs = np.unique(np.stack([got, py]), axis=1)
    assert pairs.shape[1] == np.unique(got).size == np.unique(py).size
    assert np.unique(got).size == 7


def test_cycles_raise_as_in_jax():
    ds = np.array([1, 2, 0, -1], np.int32)
    for fn in (native.tree_cut_parts, jnative.tree_cut_parts,
               tp._tree_cut_parts_py, jp._tree_cut_parts_py):
        with pytest.raises(ValueError, match="cycle"):
            fn(ds, 2)


@pytest.mark.parametrize("n_dev", [1, 3])
def test_sharded_plan_matches_jax_inputs(networks, n_dev):
    """``sharded_plan`` (each rank keeps its row) against the JAX
    ``build_sharded_inputs`` on the regional network with reservoirs and
    gages, forced cuts; and ``rank_inputs`` against ``convert.
    from_sharded_inputs`` of the JAX arrays."""
    import torch

    from troute_torch.convert import from_sharded_inputs
    jt, pt = networks["regional"]
    n = jt.n_nodes
    rng = np.random.default_rng(7)
    a = (np.arange(n) % n_dev).astype(np.int32)
    jpart, tpart = jp.partition_network(jt, n_dev, a), \
        tp.partition_network(pt, n_dev, a)
    chan = {k: rng.uniform(0.5, 2.0, n) for k in
            ("dx", "bw", "tw", "twcc", "n", "ncc", "cs", "s0")}
    n_res = pt.reservoir_rows.size
    params = np.repeat(LAKE_ROWVALS, n_res, axis=0) \
        * rng.uniform(0.9, 1.1, (n_res, 9))
    params[:, 8] = 10.0
    elev = {int(r): float(v) for r, v in
            zip(pt.reservoir_rows, rng.uniform(9, 10, n_res))}
    q0, d0 = rng.uniform(0, 5, n), rng.uniform(0, 1, n)
    qlat = rng.uniform(0, 2, (3, n))
    gages = rng.choice(n, 25, replace=False)
    obs = rng.uniform(1, 5, (13, 25))
    lov, lot = rng.uniform(1, 5, 25), -rng.uniform(0, 900, 25)
    want = build_sharded_inputs(jpart, jt, chan, params, q0, d0, elev, qlat,
                                dtype=np.float64, gage_rows=gages,
                                gage_obs=obs, gage_lo_val=lov,
                                gage_lo_time=lot)
    plan = sharded_plan(tpart, pt, chan, params, q0, d0, elev, qlat,
                        gage_rows=gages, gage_obs=obs, gage_lo_val=lov,
                        gage_lo_time=lot)
    for f in want._fields:
        w = want._asdict()[f]
        g = plan[f]
        if f in ("chan", "res_params"):
            for k, wk in w._asdict().items():
                np.testing.assert_array_equal(g[k], np.asarray(wk), err_msg=k)
            continue
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=f)
    for rank in range(n_dev):
        got = rank_inputs(plan, rank, device="cpu", dtype=torch.float64)
        conv = from_sharded_inputs(want, rank, device="cpu",
                                   dtype=torch.float64)
        for f, g in got._asdict().items():
            c = conv._asdict()[f]
            if isinstance(g, np.ndarray):
                np.testing.assert_array_equal(g, c)
                continue
            for x, y in (zip(g, c) if isinstance(g, tuple) else [(g, c)]):
                torch.testing.assert_close(x, y, rtol=0, atol=0,
                                           equal_nan=True, msg=f)


def test_partition_is_vectorized_at_scale():
    """The port's plan of a 300,000-node forest at 4 ranks with balanced
    cuts equals the JAX one (whose per-node Python loop is what makes it
    slow at CONUS size)."""
    ids, down = synthetic.regional_network(300_000, 40, 9)
    jt = jtopo.build_topology(ids, down, row_order="postorder")
    pt = port_topology(jt)
    a = tp.balanced_assignment(pt, 4)
    assert_same_partition(tp.partition_network(pt, 4, a),
                          jp.partition_network(jt, 4, a))

"""Port parity for the banded upstream sum
(``troute_torch/routing/upstream_plan.py``), the post-order topology
wrapper (``troute_torch/network/topology.py``) and the network tensors.

The plan arrays must be identical to the JAX package's; the sums are held
bit for bit to JAX in f64 and f32 (the plan fixes the order in which each
node's terms are added, and on the CPU the remainder's ``index_add`` adds
in index order like JAX's scatter-add).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from troute_tpu.network.topology import build_topology
from troute_tpu.routing import engine as jeng
from troute_tpu.routing import upstream_plan as jplan
from troute_torch import convert
from troute_torch.network.topology import build_topology_postorder
from troute_torch.routing import engine as teng
from troute_torch.routing import upstream_plan as tplan

from test_upstream_plan import random_forest

torch.set_num_threads(1)


def _plans(topo, **kw):
    n_pad = -(-topo.n_nodes // 1024) * 1024
    up = np.asarray(topo.upstream)
    return (tplan.build_upstream_plan(up, n_pad, **kw),
            jplan.build_upstream_plan(up, n_pad, **kw))


@pytest.mark.parametrize("case", ["scrambled", "postorder", "scattered"])
def test_plan_arrays_identical(case):
    rng = np.random.default_rng(7)
    if case == "scattered":
        ids, down = random_forest(4000, rng, span=200)
        topo = build_topology(ids, down)
        kw = dict(max_shifts=4, max_remainder_frac=0.05)
    else:
        ids, down = random_forest(3000, rng)
        topo = (build_topology(ids, down) if case == "scrambled"
                else build_topology_postorder(ids, down))
        kw = dict(max_shifts=8, max_remainder_frac=1.0)
    p_t, p_j = _plans(topo, **kw)
    if case == "scattered":
        assert p_t is None and p_j is None
        return
    assert p_t.n_pad == p_j.n_pad and p_t.shifts == p_j.shifts
    assert p_t.coverage == p_j.coverage
    for f in ("masks", "rem_dst", "rem_src", "upstream_sorted"):
        a, b = getattr(p_t, f), getattr(p_j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_banded_and_gather_sums_match_jax(dtype):
    rng = np.random.default_rng(7)
    ids, down = random_forest(3000, rng)
    topo = build_topology(ids, down)
    p_t, _ = _plans(topo, max_shifts=8, max_remainder_frac=1.0)
    assert p_t.rem_dst.size > 0, "the remainder path must run"
    q = np.zeros(p_t.n_pad, dtype)
    q[:topo.n_nodes] = rng.uniform(0.1, 100.0, topo.n_nodes)

    op = tplan.UpstreamOp.from_plan(p_t, device="cpu")
    got = op(torch.as_tensor(q)).numpy()
    want = np.asarray(jplan.banded_upstream_sum(
        jnp.asarray(q), jnp.asarray(p_t.masks), p_t.shifts,
        jnp.asarray(p_t.rem_dst), jnp.asarray(p_t.rem_src)))
    np.testing.assert_array_equal(got, want)
    assert not got[topo.n_nodes:].any()

    up = p_t.upstream_sorted
    got_g = teng._upstream_sum(torch.as_tensor(q[:topo.n_nodes]),
                               torch.as_tensor(up, dtype=torch.int64))
    want_g = np.asarray(jeng._upstream_sum(jnp.asarray(q[:topo.n_nodes]),
                                           jnp.asarray(up)))
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    # banded and gather forms add in the same order
    np.testing.assert_array_equal(got_g.numpy(), got[:topo.n_nodes])


def test_postorder_topology_identical_to_jax():
    """``build_topology_postorder`` rows equal
    ``build_topology(row_order="postorder")`` on the CONUS-statistics
    synthetic network, reservoir node types included."""
    ids, down = bench.synthetic_conus(n=20_000, n_basins=100)
    nt = (np.random.default_rng(1).random(ids.size) < 0.01).astype(np.int8)
    t_port = build_topology_postorder(ids, down, node_type=nt)
    t_jax = build_topology(ids, down, node_type=nt, row_order="postorder")
    for f in ("ids", "downstream", "upstream", "level", "node_type"):
        a, b = getattr(t_port, f), getattr(t_jax, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_network_arrays_match_converted_jax():
    """The port's ``network_arrays_from_topology`` builds the same tensors
    that ``convert`` carries over from the JAX ``NetworkArrays``: its plan
    runs at the network's length (the JAX plan's, 5,120, padded to a
    multiple of 1024), and ``convert`` cuts the JAX masks to it."""
    ids, down = bench.synthetic_conus(n=5000, n_basins=20)
    nt = np.zeros(ids.size, np.int8)
    nt[::500] = 1
    topo = build_topology(ids, down, node_type=nt)
    net_t = teng.network_arrays_from_topology(topo, device="cpu")
    jnet = jeng.network_arrays_from_topology(topo, need_levels=False)
    net_c = convert.from_network_arrays(jnet, device="cpu")
    assert jnet.uplan.n_pad == 5120
    assert not np.asarray(jnet.uplan.masks)[:, topo.n_nodes:].any()
    assert net_t.uplan is not None and net_t.uplan.n_pad == topo.n_nodes
    assert net_t.uplan.shifts == net_c.uplan.shifts
    for a, b in ((net_t.upstream, net_c.upstream),
                 (net_t.is_reservoir, net_c.is_reservoir),
                 (net_t.res_rows, net_c.res_rows),
                 (net_t.uplan.masks, net_c.uplan.masks),
                 (net_t.uplan.rem_dst, net_c.uplan.rem_dst),
                 (net_t.uplan.rem_src, net_c.uplan.rem_src)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_remainder_layers_name_each_node_once_and_keep_the_order():
    """``remainder_layers`` regroups a plan's remainder so that no layer
    names a node twice (a layer's ``index_add`` then needs no ordering
    between CUDA's atomic adds), and adding the layers in turn equals one
    ``index_add`` of the edges in the plan's order, bit for bit (f32):
    each node's terms keep their order."""
    ids, down = bench.synthetic_conus(n=5000, n_basins=50)
    topo = build_topology_postorder(ids, down)
    n_pad = -(-topo.n_nodes // 1024) * 1024
    plan = tplan.build_upstream_plan(np.asarray(topo.upstream), n_pad)
    counts = np.bincount(plan.rem_dst, minlength=n_pad)
    assert (counts >= 2).sum() > 10
    dst, src, cuts = tplan.remainder_layers(plan.rem_dst, plan.rem_src)
    assert len(cuts) == counts.max() - 1
    bounds = (0,) + cuts + (dst.size,)
    for a, b in zip(bounds[:-1], bounds[1:]):
        assert np.unique(dst[a:b]).size == b - a
    q = torch.as_tensor(np.random.default_rng(2).uniform(0, 9, n_pad),
                        dtype=torch.float32)
    base = torch.as_tensor(np.random.default_rng(3).uniform(0, 9, n_pad),
                           dtype=torch.float32)
    want = base.index_add(0, torch.as_tensor(plan.rem_dst, dtype=torch.int64),
                          q[torch.as_tensor(plan.rem_src, dtype=torch.int64)])
    op = tplan.UpstreamOp.from_plan(plan, device="cpu")
    assert op.rem_cuts == cuts
    got = tplan.remainder_add(base, q, op.rem_dst, op.rem_src, op.rem_cuts)
    assert torch.equal(got, want)

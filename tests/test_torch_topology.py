"""The port's own topology code (``troute_torch/network/topology.py``), its
host library (``troute_torch/native.py``, ``csrc/topology_kernels.cpp``)
and its synthetic CONUS inputs (``troute_torch/synthetic.py``) against the
JAX package's.

Topologies and synthetic inputs are integer and NumPy arrays built the
same way, so every comparison is exact: field for field, dtype included.
"""

import numpy as np
import pytest

import bench
from troute_tpu.network import topology as jtopo
from troute_torch import _build, native, synthetic
from troute_torch.network import topology as ttopo
from troute_torch.routing import upstream_plan

FIELDS = ("ids", "downstream", "upstream", "level", "node_type")


def _network(case):
    """(ids, downstream ids, node types or None) for one case."""
    if case == "synthetic":
        ids, down = synthetic.synthetic_conus(20_000, n_basins=50)
        return ids, down, None
    # reservoirs at random junctions, rows scrambled, a pruned outflow (an
    # id outside the network) and a self-loop as terminals
    ids, down = synthetic.synthetic_conus(5_000, n_basins=20, seed=3)
    rng = np.random.default_rng(11)
    nt = np.zeros(ids.size, np.int8)
    nt[rng.choice(np.flatnonzero(np.isin(ids, down)), 40,
                  replace=False)] = ttopo.NODE_RESERVOIR
    down = down.copy()
    down[rng.choice(np.flatnonzero(down > 0), 2, replace=False)] = [10**9,
                                                                    0]
    down[np.flatnonzero(down > 0)[7]] = ids[np.flatnonzero(down > 0)[7]]
    perm = rng.permutation(ids.size)
    return ids[perm], down[perm], nt[perm]


def _assert_same(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.reservoir_rows, b.reservoir_rows)
    assert a.n_levels == b.n_levels and a.max_upstreams == b.max_upstreams


@pytest.mark.parametrize("case", ["synthetic", "reservoirs"])
@pytest.mark.parametrize("row_order", [None, "postorder"])
def test_build_topology_matches_jax(case, row_order):
    ids, down, nt = _network(case)
    port = ttopo.build_topology(ids, down, node_type=nt, row_order=row_order)
    jax_side = jtopo.build_topology(ids, down, node_type=nt,
                                    row_order=row_order)
    _assert_same(port, jax_side)
    if row_order == "postorder":
        _assert_same(ttopo.build_topology_postorder(ids, down, node_type=nt),
                     jax_side)


def test_build_topology_drops_cycles_as_jax():
    ids = np.arange(1, 9)
    down = np.array([2, 3, 0, 5, 6, 4, 4, 3])  # 4 -> 5 -> 6 -> 4 is a cycle
    port = ttopo.build_topology(ids, down, on_cycle="drop")
    _assert_same(port, jtopo.build_topology(ids, down, on_cycle="drop"))
    assert port.n_nodes == 5   # 7 drained into the cycle: now terminal
    with pytest.raises(ValueError):
        ttopo.build_topology(ids, down)


@pytest.mark.parametrize("fn", ["invert_downstream", "postorder",
                                "wavefront_levels"])
def test_native_and_numpy_paths_agree(fn):
    assert native.available()
    ids, down, nt = _network("reservoirs")
    ds = ttopo.build_topology(ids, down, node_type=nt).downstream
    up = ttopo.invert_downstream_numpy(ds)
    if fn == "invert_downstream":
        got, want = native.invert_downstream(ds), up
    elif fn == "postorder":
        got = native.postorder_forest(ds, up)
        want = upstream_plan.postorder_numpy(ds, up)
    else:
        got = native.wavefront_levels(ds)
        # the NumPy sweep, with the native function out of the way
        lib, native._lib = native._lib, None
        try:
            want = ttopo.wavefront_levels(ds, up)
        finally:
            native._lib = lib
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_native_library_is_built_outside_the_source_tree():
    assert native.available()
    libs = sorted(_build.BUILD_DIR.glob("topology_kernels-*.so"))
    assert libs and all(p.parent == _build.BUILD_DIR for p in libs)
    assert not list(_build.CSRC.glob("*.so"))


@pytest.mark.parametrize("n, seed", [(1_000, 0), (20_000, 1), (54_321, 7)])
def test_synthetic_inputs_match_bench(n, seed):
    ids, down = synthetic.synthetic_conus(n, n_basins=60, seed=seed)
    jids, jdown = bench.synthetic_conus(n, n_basins=60, seed=seed)
    assert ids.dtype == jids.dtype and down.dtype == jdown.dtype
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(down, jdown)
    got = synthetic.channel_params(n, np.random.default_rng(seed))
    want = bench.channel_params(n, np.random.default_rng(seed))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert (synthetic.CONUS_SEGMENTS, synthetic.CONUS_BASINS) == (
        bench.CONUS_SEGMENTS, bench.CONUS_BASINS)


def test_cached_build_returns_its_compiler_output():
    """A cache hit returns the compiler's output of the build that made the
    library (chip_smoke.py reads registers and spills from it)."""
    src = _build.CSRC / "topology_kernels.cpp"
    flags = _build.GXX_FLAGS + ("-Wall", "-Wextra")
    first = _build.compile_cached("g++", flags, src)
    again = _build.compile_cached("g++", flags, src)
    assert first == again and first[0].parent == _build.BUILD_DIR
    assert first[0].with_suffix(".log").read_text() == first[1]

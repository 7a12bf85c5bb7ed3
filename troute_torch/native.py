"""ctypes loader for the port's host-side topology functions.

``csrc/topology_kernels.cpp`` is compiled by ``g++`` at first use into
``build/troute_torch/`` (``_build.build_host``).  Each wrapper returns
None when the library cannot be built or loaded; the callers in
``network/topology.py``, ``routing/upstream_plan.py`` and
``parallel/partition.py`` then take their NumPy fallbacks, which give
identical arrays (``connected_components``: the same basins).  Which path is taken is
logged once, at the first call.
"""

from __future__ import annotations

import ctypes
import logging

import numpy as np

from troute_torch import _build

LOG = logging.getLogger(__name__)

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        path = _build.build_host("topology_kernels")
        lib = ctypes.CDLL(str(path))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.wavefront_levels.argtypes = [i32p, ctypes.c_int64, i32p]
        lib.wavefront_levels.restype = ctypes.c_int
        lib.invert_downstream.argtypes = [i32p, ctypes.c_int64,
                                          ctypes.c_int32, i32p]
        lib.invert_downstream.restype = ctypes.c_int32
        lib.postorder_forest.argtypes = [i32p, i32p, ctypes.c_int64,
                                         ctypes.c_int32, i64p]
        lib.postorder_forest.restype = ctypes.c_int64
        lib.connected_components.argtypes = [i32p, ctypes.c_int64, i32p]
        lib.connected_components.restype = ctypes.c_int
        lib.tree_cut_parts.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64,
                                       i32p]
        lib.tree_cut_parts.restype = ctypes.c_int64
        _lib = lib
        LOG.info("host topology preprocessing: native library %s", path)
    except Exception as e:  # no g++, or the build failed
        LOG.warning("host topology preprocessing: NumPy fallbacks (native "
                    "library unavailable: %s)", e)
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def wavefront_levels(downstream: np.ndarray) -> np.ndarray | None:
    """Longest-path levels, or None without the library.  Raises
    ValueError on cycles (the NumPy path's contract)."""
    lib = _load()
    if lib is None:
        return None
    ds = np.ascontiguousarray(downstream, np.int32)
    levels = np.zeros(ds.size, np.int32)
    if lib.wavefront_levels(ds, ds.size, levels) != 0:
        raise ValueError("cycle detected in network")
    return levels


def invert_downstream(downstream: np.ndarray) -> np.ndarray | None:
    """[N, K] upstream rows (-1 padded, K the max in-degree, at least 1),
    or None without the library."""
    lib = _load()
    if lib is None:
        return None
    ds = np.ascontiguousarray(downstream, np.int32)
    k = 4
    while True:
        upstream = np.full((ds.size, k), -1, np.int32)
        maxdeg = lib.invert_downstream(ds, ds.size, k, upstream)
        if maxdeg <= k:
            return upstream[:, :max(int(maxdeg), 1)]
        k = int(maxdeg)


def postorder_forest(downstream: np.ndarray,
                     upstream: np.ndarray) -> np.ndarray | None:
    """Post-order DFS row order (the NumPy fallback's visit order), or
    None without the library.  Raises ValueError on cycles."""
    lib = _load()
    if lib is None:
        return None
    ds = np.ascontiguousarray(downstream, np.int32)
    up = np.ascontiguousarray(upstream, np.int32)
    order = np.zeros(ds.size, np.int64)
    if lib.postorder_forest(ds, up, ds.size, up.shape[1], order) != ds.size:
        raise ValueError("drainage graph must be a forest (no cycles)")
    return order


def connected_components(downstream: np.ndarray) -> np.ndarray | None:
    """[N] int32 basin label per node (union along downstream edges,
    labels in first-appearance order), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    ds = np.ascontiguousarray(downstream, np.int32)
    labels = np.zeros(ds.size, np.int32)
    lib.connected_components(ds, ds.size, labels)
    return labels


def tree_cut_parts(downstream: np.ndarray, cap: int) -> np.ndarray | None:
    """[N] int32 part id: connected parts of at most ``cap`` nodes made by
    the fewest tree-edge cuts, or None without the library.  Raises
    ValueError on cycles."""
    lib = _load()
    if lib is None:
        return None
    ds = np.ascontiguousarray(downstream, np.int32)
    part = np.zeros(ds.size, np.int32)
    if lib.tree_cut_parts(ds, ds.size, int(cap), part) < 0:
        raise ValueError("cycle detected in network")
    return part

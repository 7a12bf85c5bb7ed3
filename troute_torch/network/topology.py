"""Array-first routing topology for the port.

A copy, read and trimmed, of the NumPy topology code of
``troute_tpu/network/topology.py``: the port imports nothing of the JAX
package.  The network is preprocessed once on the host into columnar
arrays: per-node padded upstream row lists, a wavefront level per node
(longest path from a headwater), and a node type; and the level-scan
schedule of ``route()`` (``level_nodes``, ``level_chunks``).
``from_connections`` is not ported.

Host preprocessing runs the port's native functions
(``troute_torch/native.py``) when they build and the NumPy fallbacks
here otherwise; both give identical arrays.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import cached_property
from typing import Sequence

import numpy as np

from troute_torch import native
from troute_torch.routing.upstream_plan import postorder

__all__ = ["TERMINAL", "NODE_MC", "NODE_RESERVOIR", "RoutingTopology",
           "build_topology", "build_topology_postorder"]

TERMINAL = -1
NODE_MC = 0
NODE_RESERVOIR = 1


@dataclass(frozen=True)
class RoutingTopology:
    """Immutable columnar network topology.

    All index arrays refer to row positions (0..N-1); ``ids`` maps rows
    back to external feature ids.
    """

    ids: np.ndarray          # int64 [N] external node ids (unique)
    downstream: np.ndarray   # int32 [N] row of the downstream node, -1 if terminal
    upstream: np.ndarray     # int32 [N, K] rows of the upstream nodes, -1 pad
    level: np.ndarray        # int32 [N] wavefront level (0 = headwater)
    node_type: np.ndarray    # int8  [N] NODE_MC | NODE_RESERVOIR

    @property
    def n_nodes(self) -> int:
        return int(self.ids.shape[0])

    @property
    def max_upstreams(self) -> int:
        return int(self.upstream.shape[1])

    @property
    def n_levels(self) -> int:
        return int(self.level.max()) + 1 if self.n_nodes else 0

    @cached_property
    def index_of(self) -> dict:
        return {int(i): k for k, i in enumerate(self.ids)}

    @cached_property
    def reservoir_rows(self) -> np.ndarray:
        return np.flatnonzero(self.node_type == NODE_RESERVOIR).astype(np.int32)

    @cached_property
    def level_nodes(self) -> np.ndarray:
        """[n_levels, widest level] rows grouped by level in ascending row
        order, -1 padded: the level scan's schedule."""
        order = np.argsort(self.level, kind="stable")
        counts = np.bincount(self.level, minlength=self.n_levels)
        width = int(counts.max()) if counts.size else 0
        out = np.full((self.n_levels, width), -1, np.int32)
        start = 0
        for lvl, c in enumerate(counts):
            out[lvl, :c] = order[start:start + c]
            start += c
        return out

    def level_chunks(self, width: int) -> np.ndarray:
        """[n_chunks, width] rows, -1 padded, in level order; a chunk never
        spans two levels.  Nodes of one level are independent, so a level
        split over consecutive rows keeps the level scan's results, and
        the schedule costs O(N + n_levels x width) instead of O(n_levels x
        widest level).  The JAX package rounds ``width`` to the TPU's
        128-lane vector; any width will do here."""
        order = np.argsort(self.level, kind="stable")
        counts = np.bincount(self.level, minlength=self.n_levels)
        if counts.size:
            width = min(width, int(counts.max()))
        width = max(int(width), 1)
        chunks = []
        start = 0
        for c in counts:
            for off in range(0, int(c), width):
                chunk = order[start + off:start + min(off + width, c)]
                row = np.full(width, -1, np.int32)
                row[:chunk.size] = chunk
                chunks.append(row)
            start += c
        if not chunks:
            return np.full((1, width), -1, np.int32)
        return np.stack(chunks)


def build_topology(ids: Sequence[int], downstream_ids: Sequence[int],
                   node_type: Sequence[int] | None = None,
                   terminal_codes: Sequence[int] = (0,),
                   on_cycle: str = "raise",
                   row_order: str | None = None) -> RoutingTopology:
    """Build the columnar topology from parallel id/to-id arrays.

    ``downstream_ids`` entries that are terminal codes, that reference ids
    outside ``ids`` (pruned-domain outflows), or that point at the node
    itself become terminal.  ``on_cycle``: "raise" errors on circular
    networks; "drop" removes the nodes on cycles (nodes draining into a
    dropped cycle become terminal), as the reference never reaches them.
    ``row_order``: None keeps input order; ``"postorder"`` relabels rows
    by a post-order DFS of the drainage forest, so nearly every edge has
    row displacement 1 (the layout the banded upstream sum wants).
    """
    ids = np.asarray(ids, np.int64)
    to = np.asarray(downstream_ids, np.int64)
    n = ids.size
    if np.unique(ids).size != n:
        raise ValueError("node ids must be unique")

    order = np.argsort(ids)
    sorted_ids = ids[order]
    pos = np.clip(np.searchsorted(sorted_ids, to), 0, n - 1)
    found = sorted_ids[pos] == to
    downstream = np.where(found, order[pos], TERMINAL).astype(np.int32)
    downstream[np.isin(to, np.asarray(terminal_codes, np.int64))] = TERMINAL
    downstream[downstream == np.arange(n)] = TERMINAL

    nt = (np.asarray(node_type, np.int8) if node_type is not None
          else np.zeros(n, np.int8))

    if on_cycle == "drop":
        keep = _acyclic_mask(downstream)
        if not keep.all():
            logging.getLogger(__name__).warning(
                "dropping %d nodes on circular networks", (~keep).sum())
            idx_map = np.full(n, -1, np.int64)
            idx_map[keep] = np.arange(int(keep.sum()))
            ids = ids[keep]
            old_ds = downstream[keep]
            downstream = np.where(old_ds >= 0, idx_map[old_ds],
                                  TERMINAL).astype(np.int32)
            nt = nt[keep]
            n = ids.size
    elif on_cycle != "raise":
        raise ValueError(f"unknown on_cycle {on_cycle!r}")

    upstream = invert_downstream(downstream)
    if row_order == "postorder":
        order = postorder(downstream, upstream)
        inv = np.empty(n, np.int64)
        inv[order] = np.arange(n)
        ids = ids[order]
        downstream = np.where(downstream[order] >= 0,
                              inv[np.maximum(downstream[order], 0)],
                              TERMINAL).astype(np.int32)
        nt = nt[order]
        upstream = invert_downstream(downstream)
    elif row_order is not None:
        raise ValueError(f"unknown row_order {row_order!r}")
    level = wavefront_levels(downstream, upstream)
    return RoutingTopology(ids=ids, downstream=downstream, upstream=upstream,
                           level=level, node_type=nt)


def build_topology_postorder(ids: Sequence[int], downstream_ids: Sequence[int],
                             node_type: Sequence[int] | None = None,
                             terminal_codes: Sequence[int] = (0,),
                             on_cycle: str = "raise") -> RoutingTopology:
    """``build_topology(..., row_order="postorder")``."""
    return build_topology(ids, downstream_ids, node_type, terminal_codes,
                          on_cycle, row_order="postorder")


def _acyclic_mask(downstream: np.ndarray) -> np.ndarray:
    """True for nodes that reach a terminal.  Kahn peeling from the
    upstream side marks all DAG nodes; the rest sit on or above cycles."""
    n = downstream.size
    remaining = np.zeros(n, np.int64)
    valid = downstream >= 0
    np.add.at(remaining, downstream[valid], 1)
    stack = list(np.flatnonzero(remaining == 0))
    seen = np.zeros(n, bool)
    while stack:
        u = stack.pop()
        seen[u] = True
        d = downstream[u]
        if d >= 0:
            remaining[d] -= 1
            if remaining[d] == 0:
                stack.append(d)
    return seen


def invert_downstream(downstream: np.ndarray) -> np.ndarray:
    """Padded [N, K] upstream rows from the downstream pointers: the
    native function when it builds, else ``invert_downstream_numpy``."""
    up = native.invert_downstream(downstream)
    return invert_downstream_numpy(downstream) if up is None else up


def invert_downstream_numpy(downstream: np.ndarray) -> np.ndarray:
    """``invert_downstream`` in NumPy: each node's upstream rows in
    ascending order, -1 padded to the max in-degree (at least 1)."""
    n = downstream.size
    srcs = np.flatnonzero(downstream >= 0).astype(np.int32)
    dsts = downstream[srcs]
    if srcs.size == 0:
        return np.full((n, 1), -1, np.int32)
    sort = np.argsort(dsts, kind="stable")
    srcs, dsts = srcs[sort], dsts[sort]
    indeg = np.bincount(dsts, minlength=n)
    upstream = np.full((n, max(int(indeg.max()), 1)), -1, np.int32)
    # position of each src within its destination's group
    rank = np.arange(srcs.size) - np.concatenate([[0], np.cumsum(indeg)])[dsts]
    upstream[dsts, rank] = srcs
    return upstream


def wavefront_levels(downstream: np.ndarray, upstream: np.ndarray
                     ) -> np.ndarray:
    """Longest-path-from-headwater level per node: the native function
    when it builds, else one vectorised NumPy sweep per level."""
    lv = native.wavefront_levels(downstream)
    if lv is not None:
        return lv
    n = downstream.size
    remaining = (upstream >= 0).sum(axis=1).astype(np.int64)
    level = np.zeros(n, np.int32)
    frontier = np.flatnonzero(remaining == 0)
    lvl = processed = 0
    while frontier.size:
        level[frontier] = lvl
        processed += frontier.size
        ds = downstream[frontier]
        ds = ds[ds >= 0]
        np.subtract.at(remaining, ds, 1)
        frontier = np.unique(ds[remaining[ds] == 0])
        lvl += 1
    if processed != n:
        raise ValueError("cycle detected in network")
    return level

"""Banded upstream-flow summation: masked shifts instead of gathers.

Port of ``troute_tpu/routing/upstream_plan.py``.  Each edge is written as
a row displacement ``d = row(downstream) - row(upstream)``; then

    up_sum = sum_d  shift(q, d) * mask_d   (+ sparse remainder)

where ``mask_d`` marks the rows with an upstream at displacement ``d``.
The plan covers the most frequent displacements with masks and sends the
rest through a small gather plus ``index_add``.  The plan also fixes the
order in which each node's terms are added (band rank, then remainder),
and ``upstream_sorted`` lists each node's upstreams in that order, so the
gather form adds in the same order as the banded form; f32 parity with
the JAX engine depends on that order.

``UpstreamPlan``, ``postorder`` and ``build_upstream_plan`` are NumPy,
copied from the JAX module with their behaviour unchanged: the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

MAX_SHIFTS = 32
# remainder edges cost ~2 latency-bound memory ops each (gather + scatter);
# past ~20% of edges the banded form loses its advantage over the gather
MAX_REMAINDER_FRAC = 0.20


@dataclass(frozen=True)
class UpstreamPlan:
    """Host-side banded summation plan over ``n_pad`` rows: the network's
    own length in ``route_stepped``, a shard's padded length in a
    partition.

    ``masks[i]`` marks rows whose upstream at displacement ``shifts[i]``
    exists; remainder edges are (dst, src) row pairs handled by a sparse
    gather + scatter-add.  ``upstream_sorted`` is the input ``[N, K]``
    upstream list with each node's columns reordered to the plan's
    accumulation order (band rank, then remainder) so the banded sum and
    the reference gather sum add in the same order (bit-identical apart
    from unordered scatter duplicates, which only occur for nodes with
    two or more remainder edges).
    """

    n_pad: int
    shifts: tuple[int, ...]        # static band displacements
    masks: np.ndarray              # bool [D, n_pad]
    rem_dst: np.ndarray            # int32 [E_rem]
    rem_src: np.ndarray            # int32 [E_rem]
    coverage: float                # fraction of edges in the band
    upstream_sorted: np.ndarray    # int32 [N, K]


def postorder(downstream: np.ndarray, upstream: np.ndarray) -> np.ndarray:
    """Post-order DFS of the drainage forest: children before parents,
    subtrees contiguous.  Returns [N] new position -> original row.

    The port's native function when it builds (``troute_torch.native``;
    the Python DFS costs ~6 s at CONUS scale vs ~50 ms native), else
    ``postorder_numpy``; both give the identical order (tailwaters
    ascending, children in upstream-column order)."""
    from troute_torch import native
    nat = native.postorder_forest(downstream, upstream)
    return postorder_numpy(downstream, upstream) if nat is None else nat


def postorder_numpy(downstream: np.ndarray, upstream: np.ndarray
                    ) -> np.ndarray:
    """``postorder`` in Python: the fallback without the native library."""
    n = downstream.shape[0]
    order = np.empty(n, np.int64)
    pos = 0
    visited = np.zeros(n, bool)
    tails = np.flatnonzero(np.asarray(downstream) < 0)
    up = np.asarray(upstream)
    for t in tails:
        stack = [(int(t), 0)]
        while stack:
            v, ci = stack[-1]
            kids = up[v]
            while ci < kids.shape[0] and (kids[ci] < 0
                                          or visited[kids[ci]]):
                ci += 1
            if ci < kids.shape[0]:
                stack[-1] = (v, ci + 1)
                stack.append((int(kids[ci]), 0))
            else:
                stack.pop()
                visited[v] = True
                order[pos] = v
                pos += 1
    assert pos == n, "drainage graph must be a forest (no cycles)"
    return order


def build_upstream_plan(upstream: np.ndarray, n_pad: int,
                        max_shifts: int = MAX_SHIFTS,
                        max_remainder_frac: float = MAX_REMAINDER_FRAC
                        ) -> UpstreamPlan | None:
    """Build the banded plan for an ``[N, K]`` padded upstream list.

    Returns None when the row order is too scattered for banding (more
    than ``max_remainder_frac`` of edges outside the ``max_shifts`` most
    frequent displacements) — callers then keep the gather form.
    """
    up = np.asarray(upstream)
    n, kup = up.shape
    dst_all, src_all = [], []
    for k in range(kup):
        col = up[:, k]
        m = col >= 0
        dst_all.append(np.flatnonzero(m))
        src_all.append(col[m].astype(np.int64))
    dst = np.concatenate(dst_all) if dst_all else np.zeros(0, np.int64)
    src = np.concatenate(src_all) if src_all else np.zeros(0, np.int64)
    n_edges = dst.size
    if n_edges == 0:
        return UpstreamPlan(
            n_pad=n_pad, shifts=(), masks=np.zeros((0, n_pad), bool),
            rem_dst=np.zeros(0, np.int32), rem_src=np.zeros(0, np.int32),
            coverage=1.0, upstream_sorted=up.astype(np.int32))

    disp = dst - src
    vals, counts = np.unique(disp, return_counts=True)
    top = np.argsort(counts)[::-1][:max_shifts]
    band_vals = vals[top]
    in_band = np.isin(disp, band_vals)
    coverage = float(in_band.sum()) / n_edges
    if 1.0 - coverage > max_remainder_frac:
        return None

    # deterministic band order: by descending frequency, ties by value
    order = np.lexsort((band_vals, -counts[top]))
    shifts = tuple(int(band_vals[i]) for i in order)

    masks = np.zeros((len(shifts), n_pad), bool)
    for i, d in enumerate(shifts):
        masks[i, dst[disp == d]] = True
    rem_dst = dst[~in_band].astype(np.int32)
    rem_src = src[~in_band].astype(np.int32)

    # per-node column order matching the banded accumulation order
    shift_arr = np.asarray(shifts, np.int64)
    ssort = np.argsort(shift_arr)
    sorted_shifts = shift_arr[ssort]

    def rank_lookup(d):
        if not shifts:
            return np.full(d.shape, 0, np.int64)
        pos = np.clip(np.searchsorted(sorted_shifts, d), 0,
                      len(shifts) - 1)
        return np.where(sorted_shifts[pos] == d, ssort[pos], len(shifts))

    key = np.full(up.shape, np.iinfo(np.int64).max, np.int64)
    for k in range(kup):
        col = up[:, k]
        m = col >= 0
        d = np.flatnonzero(m) - col[m]
        key[m, k] = rank_lookup(d)
    ksort = np.argsort(key, axis=1, kind="stable")
    up_sorted = np.take_along_axis(up, ksort, axis=1)
    return UpstreamPlan(
        n_pad=n_pad, shifts=shifts, masks=masks,
        rem_dst=rem_dst, rem_src=rem_src, coverage=coverage,
        upstream_sorted=up_sorted.astype(np.int32))


def remainder_layers(rem_dst, rem_src):
    """The remainder edges regrouped in layers: layer j holds each node's
    j-th remainder edge (in the plan's edge order), so no layer names a
    node twice.  Returns (dst, src, cuts): int64 arrays in layer order and
    the offsets where layers 1, 2, ... begin.  Adding the layers in turn
    adds each node's terms in the plan's order, and a layer's
    ``index_add`` writes each node once, so on CUDA (atomic adds) the sum
    is deterministic and equals the CPU's sequential ``index_add``."""
    dst = np.asarray(rem_dst, np.int64)
    src = np.asarray(rem_src, np.int64)
    if dst.size == 0:
        return dst, src, ()
    order = np.argsort(dst, kind="stable")
    ds = dst[order]
    occ = np.empty(dst.size, np.int64)
    occ[order] = np.arange(ds.size) - np.searchsorted(ds, ds)
    layered = np.lexsort((np.arange(dst.size), occ))
    cuts = np.searchsorted(occ[layered], np.arange(1, occ.max() + 1))
    return dst[layered], src[layered], tuple(int(c) for c in cuts)


class UpstreamOp(NamedTuple):
    """A plan's arrays on one device, callable as the upstream sum.  The
    remainder edges are in ``remainder_layers``' order with ``rem_cuts``
    its layer offsets (none: one layer, as a plan carried from the JAX
    package is)."""

    masks: torch.Tensor       # bool [D, n_pad]
    rem_dst: torch.Tensor     # int64 [E_rem]
    rem_src: torch.Tensor     # int64 [E_rem]
    shifts: tuple[int, ...]
    rem_cuts: tuple[int, ...] = ()

    @classmethod
    def from_plan(cls, plan: UpstreamPlan, *, device) -> "UpstreamOp":
        return cls.from_arrays(plan.masks, plan.rem_dst, plan.rem_src,
                               plan.shifts, device=device)

    @classmethod
    def from_arrays(cls, masks, rem_dst, rem_src, shifts, *,
                    device) -> "UpstreamOp":
        """From host remainder arrays, regrouped in layers (``masks`` a
        host array or a tensor)."""
        dst, src, cuts = remainder_layers(rem_dst, rem_src)
        return cls(torch.as_tensor(masks, device=device),
                   torch.as_tensor(dst, device=device),
                   torch.as_tensor(src, device=device), tuple(shifts), cuts)

    @property
    def n_pad(self) -> int:
        return int(self.masks.shape[1])

    def __call__(self, q: torch.Tensor) -> torch.Tensor:
        return banded_upstream_sum(q, self.masks, self.shifts,
                                   self.rem_dst, self.rem_src, self.rem_cuts)


def remainder_add(up, q, rem_dst, rem_src, rem_cuts: tuple[int, ...] = ()):
    """``up`` plus q[rem_src] at rem_dst, one ``index_add`` per layer of
    ``remainder_layers`` (``rem_cuts`` its offsets)."""
    bounds = (0,) + tuple(rem_cuts) + (rem_dst.shape[0],)
    for a, b in zip(bounds[:-1], bounds[1:]):
        up = up.index_add(0, rem_dst[a:b], q[rem_src[a:b]])
    return up


def banded_upstream_sum(q, masks, shifts: tuple[int, ...],
                        rem_dst=None, rem_src=None,
                        rem_cuts: tuple[int, ...] = ()):
    """[n_pad] upstream-flow sum via masked shifts (see module docstring).

    The terms are added in the plan's order: the shifts in turn, then the
    remainder through ``index_add``, layer by layer (``remainder_add``).
    On the CPU ``index_add`` adds in index order, as the JAX scatter-add
    does; on CUDA it uses atomics, which add a node's terms in the plan's
    order only when each layer names the node once: remainders in
    ``remainder_layers``' order with their ``rem_cuts``.
    """
    n = q.shape[0]
    up = torch.zeros_like(q)
    if shifts:
        lo = max(max(shifts), 0)
        hi = max(-min(shifts), 0)
        qx = q
        if lo or hi:
            qx = torch.cat([q.new_zeros(lo), q, q.new_zeros(hi)])
        for i, d in enumerate(shifts):
            up = up + torch.where(masks[i], qx[lo - d:lo - d + n], 0.0)
    if rem_dst is not None and rem_dst.shape[0]:
        up = remainder_add(up, q, rem_dst, rem_src, rem_cuts)
    return up

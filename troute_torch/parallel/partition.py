"""Domain decomposition of the river network across the ranks of a process
group.

Port of ``troute_tpu/parallel/partition.py``: NumPy host code on the port's
``RoutingTopology``, with the same fields and values.  Each rank owns a
contiguous padded block of nodes; the few junction edges that cross rank
boundaries become a halo exchange, run once per step (per sweep in strict
mode) by ``parallel/sharded_engine.py:make_exchange``.

Partitioning is by independent drainage basin (connected components of the
junction graph) with greedy size balancing (``greedy_basin_assignment``),
or by ``balanced_assignment``, which splits large basins with few cut
edges; any explicit assignment can be supplied instead (to force cut edges
in tests, for example).

``partition_network`` gives the JAX function's arrays, but its node loop
runs in NumPy and only the cut edges, in the same (node, column) order, go
through Python: at CONUS size (2.7M nodes) the per-node Python loop of the
JAX function takes tens of seconds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from troute_torch.network.topology import RoutingTopology

# A shard's length is a multiple of PAD_MULTIPLE rows: the JAX partition's
# layout (from the TPU's 8 x 128 tiles), kept so that a partition equals the
# JAX package's field for field.  Pad slots are ordinary invalid rows
# (global_row -1) and carry no edge.
PAD_MULTIPLE = 1024


@dataclass(frozen=True)
class NetworkPartition:
    """Host-side index plan for a sharded network.

    Extended local array layout on each rank: positions [0, n_local) are
    owned nodes, positions [n_local, n_local + n_halo) are halo slots
    holding imported remote upstream flows.
    """

    n_dev: int
    n_local: int
    n_halo: int
    n_export: int
    # [n_dev, n_local] global row held at each (rank, slot); -1 pad
    global_row: np.ndarray
    # [N] owning rank / local slot of each global row
    owner: np.ndarray
    local_slot: np.ndarray
    # [n_dev, n_local, K] upstream indices into the extended local array; -1 pad
    upstream_local: np.ndarray
    # [n_dev, n_export] local slots whose flow is exported (clamped 0 pad)
    export_slot: np.ndarray
    # [n_dev, n_halo] source (rank, export position) for each halo slot
    halo_src_dev: np.ndarray
    halo_src_pos: np.ndarray
    # --- neighbor-exchange plan ---
    # [n_rounds, n_pairs, 2] (src_rank, dst_rank) partial permutation per
    # round; -1 pad.  Each rank sends and receives at most one message per
    # round (greedy edge colouring of the rank communication digraph), so
    # rounds = max neighbour degree, and each message carries only that
    # pair's cut-edge values, where the all-gather form sends every
    # exported value to every rank.
    perm_pairs: np.ndarray
    # [n_dev, n_rounds, W] local slots packed into the round's send buffer
    send_slot: np.ndarray
    # [n_dev, n_rounds, W] halo positions the received buffer lands in (-1 pad)
    recv_pos: np.ndarray
    # [n_dev, n_boundary] local rows with any remote upstream (-1 pad);
    # the rows solved again after the exchange
    boundary_rows: np.ndarray
    # --- per-shard banded upstream-sum plan (see routing/upstream_plan) ---
    # the interior upstream sum as masked shifts over local slots; in-shard
    # out-of-band edges ride a sparse remainder; halo-referencing rows are
    # the boundary rows, summed again with the full gather after the
    # exchange.  band_shifts is None when the local slot order is too
    # scattered to band.
    band_shifts: tuple | None = None
    band_masks: np.ndarray | None = None    # bool [n_dev, D, n_local]
    band_rem_dst: np.ndarray | None = None  # int32 [n_dev, E] (-1 pad)
    band_rem_src: np.ndarray | None = None  # int32 [n_dev, E]
    band_coverage: float = 0.0

    @property
    def cut_edges(self) -> int:
        return int((self.halo_src_dev >= 0).sum())


def _components(topo: RoutingTopology) -> np.ndarray:
    """Connected-component label per node (union along downstream edges)."""
    from troute_torch import native
    labels = native.connected_components(topo.downstream)
    if labels is not None:
        return labels
    n = topo.n_nodes
    parent = np.arange(n)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for i in range(n):
        d = topo.downstream[i]
        if d >= 0:
            ra, rb = find(i), find(int(d))
            if ra != rb:
                parent[ra] = rb
    return np.array([find(i) for i in range(n)])


def greedy_basin_assignment(topo: RoutingTopology, n_dev: int) -> np.ndarray:
    """Assign whole basins to ranks, largest first to the lightest bin."""
    comp = _components(topo)
    labels, counts = np.unique(comp, return_counts=True)
    order = np.argsort(-counts)
    load = np.zeros(n_dev, np.int64)
    label_dev = np.zeros(labels.size, np.int32)
    for k in order:
        d = int(np.argmin(load))
        label_dev[k] = d
        load[d] += counts[k]
    return label_dev[np.searchsorted(labels, comp)]


def partition_network(topo: RoutingTopology, n_dev: int,
                      assignment: np.ndarray | None = None
                      ) -> NetworkPartition:
    """Build the sharded index plan.

    Args:
        assignment: optional [N] rank per node; defaults to greedy basin
            packing (zero cut edges when basins fit).
    """
    n = topo.n_nodes
    if assignment is None:
        assignment = greedy_basin_assignment(topo, n_dev)
    assignment = np.asarray(assignment, np.int32)

    counts = np.bincount(assignment, minlength=n_dev)
    n_local = max(int(counts.max()), 1)
    n_local = -(-n_local // PAD_MULTIPLE) * PAD_MULTIPLE

    global_row = np.full((n_dev, n_local), -1, np.int64)
    local_slot = np.full(n, -1, np.int64)
    for d in range(n_dev):
        rows = np.flatnonzero(assignment == d)
        global_row[d, :rows.size] = rows
        local_slot[rows] = np.arange(rows.size)

    up = np.asarray(topo.upstream, np.int64)
    K = topo.max_upstreams
    upstream_local = np.full((n_dev, n_local, K), -1, np.int64)
    has = up >= 0
    up_dev = assignment[np.where(has, up, 0)]
    # in-shard edges in one step
    vv, kk = np.nonzero(has & (up_dev == assignment[:, None]))
    upstream_local[assignment[vv], local_slot[vv], kk] = local_slot[up[vv, kk]]

    # cut edges: upstream u (on rank(u)) feeding node v (on rank(v) !=
    # rank(u)), in (v, k) order as the JAX function visits them
    exports: list[list[int]] = [[] for _ in range(n_dev)]   # local slots per rank
    export_pos: dict[tuple[int, int], int] = {}             # (rank, slot) -> pos
    imports: list[list[tuple[int, int]]] = [[] for _ in range(n_dev)]
    halo_of: dict[tuple[int, int], int] = {}                # (rank_v, global_u) -> halo idx
    cv, ck = np.nonzero(has & (up_dev != assignment[:, None]))
    for v, k in zip(cv.tolist(), ck.tolist()):
        u = int(up[v, k])
        dv, sv = int(assignment[v]), int(local_slot[v])
        du, su = int(assignment[u]), int(local_slot[u])
        key = (du, su)
        if key not in export_pos:
            export_pos[key] = len(exports[du])
            exports[du].append(su)
        hkey = (dv, u)
        if hkey not in halo_of:
            halo_of[hkey] = len(imports[dv])
            imports[dv].append((du, export_pos[key]))
        upstream_local[dv, sv, k] = n_local + halo_of[hkey]

    n_export = max((len(e) for e in exports), default=0)
    n_halo = max((len(i) for i in imports), default=0)
    n_export = max(n_export, 1)
    n_halo = max(n_halo, 1)

    export_slot = np.zeros((n_dev, n_export), np.int64)
    halo_src_dev = np.full((n_dev, n_halo), -1, np.int64)
    halo_src_pos = np.zeros((n_dev, n_halo), np.int64)
    for d in range(n_dev):
        for p, s in enumerate(exports[d]):
            export_slot[d, p] = s
        for h, (sd, sp) in enumerate(imports[d]):
            halo_src_dev[d, h] = sd
            halo_src_pos[d, h] = sp

    # ---- neighbor-exchange plan ----
    # message (s -> d): the halo values rank d imports from rank s.
    # msgs[(s, d)] = list of (src local slot on s, halo position on d)
    msgs: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for d in range(n_dev):
        for h, (sd, sp) in enumerate(imports[d]):
            msgs.setdefault((sd, d), []).append((exports[sd][sp], h))

    # greedy edge colouring: each round is a partial permutation
    rounds: list[dict[tuple[int, int], list]] = []
    for key, vals in sorted(msgs.items(), key=lambda kv: -len(kv[1])):
        s, d = key
        placed = False
        for rnd in rounds:
            if all(ks != s for ks, _ in rnd) and \
                    all(kd != d for _, kd in rnd):
                rnd[key] = vals
                placed = True
                break
        if not placed:
            rounds.append({key: vals})

    n_rounds = len(rounds)
    W = max((len(v) for v in msgs.values()), default=0)
    n_pairs = max((len(r) for r in rounds), default=0)
    perm_pairs = np.full((n_rounds, max(n_pairs, 1), 2), -1, np.int64)
    send_slot = np.zeros((n_dev, n_rounds, max(W, 1)), np.int64)
    recv_pos = np.full((n_dev, n_rounds, max(W, 1)), -1, np.int64)
    for r, rnd in enumerate(rounds):
        for p, ((s, d), vals) in enumerate(sorted(rnd.items())):
            perm_pairs[r, p] = (s, d)
            for w, (slot, hpos) in enumerate(vals):
                send_slot[s, r, w] = slot
                recv_pos[d, r, w] = hpos

    # rows whose upstream list references any halo slot
    boundary = [np.flatnonzero((upstream_local[d] >= n_local).any(axis=1))
                for d in range(n_dev)]
    B = max((b.size for b in boundary), default=0)
    boundary_rows = np.full((n_dev, max(B, 1)), -1, np.int64)
    for d, b in enumerate(boundary):
        boundary_rows[d, :b.size] = b

    band = _banded_local_plans(upstream_local, n_local)

    return NetworkPartition(
        n_dev=n_dev, n_local=n_local, n_halo=n_halo, n_export=n_export,
        global_row=global_row, owner=assignment.astype(np.int64),
        local_slot=local_slot, upstream_local=upstream_local,
        export_slot=export_slot, halo_src_dev=halo_src_dev,
        halo_src_pos=halo_src_pos, perm_pairs=perm_pairs,
        send_slot=send_slot, recv_pos=recv_pos,
        boundary_rows=boundary_rows, **band)


def _banded_local_plans(upstream_local: np.ndarray, n_local: int,
                        max_shifts: int = 32,
                        max_remainder_frac: float = 0.25) -> dict:
    """Per-shard banded plan over IN-SHARD edges (local slot < n_local).

    Local slots keep global row order within each rank, so a post-order
    topology keeps almost every in-shard edge at slot displacement 1 even
    after balanced splitting; the few out-of-band edges become a sparse
    remainder.  Halo-referencing rows are left out: they are the
    partition's boundary rows, summed with the full gather after the
    exchange.  The shifts are ordered as ``build_upstream_plan`` orders
    them (descending frequency, ties by value), so at world size 1 the
    shard adds each node's terms in ``route_stepped``'s order.
    """
    n_dev, _, K = upstream_local.shape
    dsts, srcs, disps = [], [], []
    for d in range(n_dev):
        up = upstream_local[d]
        dst_l, src_l = [], []
        for k in range(K):
            col = up[:, k]
            m = (col >= 0) & (col < n_local)
            dst_l.append(np.flatnonzero(m))
            src_l.append(col[m])
        dst = np.concatenate(dst_l) if dst_l else np.zeros(0, np.int64)
        src = np.concatenate(src_l) if src_l else np.zeros(0, np.int64)
        dsts.append(dst)
        srcs.append(src)
        disps.append(dst - src)
    disp_all = np.concatenate(disps) if disps else np.zeros(0, np.int64)
    none = dict(band_shifts=None, band_masks=None, band_rem_dst=None,
                band_rem_src=None, band_coverage=0.0)
    if disp_all.size == 0:
        return dict(band_shifts=(),
                    band_masks=np.zeros((n_dev, 0, n_local), bool),
                    band_rem_dst=np.full((n_dev, 1), -1, np.int32),
                    band_rem_src=np.zeros((n_dev, 1), np.int32),
                    band_coverage=1.0)
    vals, counts = np.unique(disp_all, return_counts=True)
    top = np.argsort(counts)[::-1][:max_shifts]
    band_vals = vals[top]
    order = np.lexsort((band_vals, -counts[top]))
    shifts = tuple(int(band_vals[i]) for i in order)
    in_band_total = int(np.isin(disp_all, band_vals).sum())
    coverage = in_band_total / disp_all.size
    if 1.0 - coverage > max_remainder_frac:
        return none

    sarr = np.asarray(shifts, np.int64)
    ssort = np.argsort(sarr)
    sorted_s = sarr[ssort]
    D = len(shifts)
    masks = np.zeros((n_dev, D, n_local), bool)
    rem_d, rem_s = [], []
    for d in range(n_dev):
        dst, src, dd = dsts[d], srcs[d], disps[d]
        pos = np.clip(np.searchsorted(sorted_s, dd), 0, D - 1)
        rank = np.where(sorted_s[pos] == dd, ssort[pos], D)
        inb = rank < D
        masks[d, rank[inb], dst[inb]] = True
        rem_d.append(dst[~inb])
        rem_s.append(src[~inb])
    E = max(1, max(r.size for r in rem_d))
    rdst = np.full((n_dev, E), -1, np.int32)
    rsrc = np.zeros((n_dev, E), np.int32)
    for d in range(n_dev):
        rdst[d, :rem_d[d].size] = rem_d[d]
        rsrc[d, :rem_s[d].size] = rem_s[d]
    return dict(band_shifts=shifts, band_masks=masks, band_rem_dst=rdst,
                band_rem_src=rsrc, band_coverage=coverage)


def scatter_to_shards(part: NetworkPartition, arr: np.ndarray,
                      fill=0.0) -> np.ndarray:
    """[N, ...] global array -> [n_dev, n_local, ...] padded shard layout."""
    out_shape = (part.n_dev, part.n_local) + arr.shape[1:]
    out = np.full(out_shape, fill, dtype=arr.dtype)
    mask = part.global_row >= 0
    out[mask] = arr[part.global_row[mask]]
    return out


def gather_from_shards(part: NetworkPartition, arr: np.ndarray) -> np.ndarray:
    """[n_dev, n_local, ...] shard layout -> [N, ...] global array."""
    n = part.owner.size
    out = np.zeros((n,) + arr.shape[2:], dtype=arr.dtype)
    mask = part.global_row >= 0
    out[part.global_row[mask]] = arr[mask]
    return out


def _tree_cut_parts_py(downstream: np.ndarray, cap: int) -> np.ndarray:
    """``native.tree_cut_parts`` in Python, the fallback without the
    library (same algorithm: one topological pass cutting any child whose
    inclusion would push its parent's accumulated part past ``cap``)."""
    n = downstream.size
    indeg = np.zeros(n, np.int64)
    valid = downstream >= 0
    np.add.at(indeg, downstream[valid], 1)
    order = list(np.flatnonzero(indeg == 0))
    acc = np.ones(n, np.int64)
    cut = np.zeros(n, bool)
    head = 0
    while head < len(order):
        u = int(order[head])
        head += 1
        d = int(downstream[u])
        if acc[u] >= cap:
            cut[u] = True
        if d >= 0:
            if not cut[u]:
                if acc[d] + acc[u] > cap:
                    cut[u] = True
                else:
                    acc[d] += acc[u]
            indeg[d] -= 1
            if indeg[d] == 0:
                order.append(d)
    if len(order) != n:
        raise ValueError("cycle detected in network")
    part = np.full(n, -1, np.int32)
    nxt = 0
    for u in reversed(order):
        d = int(downstream[u])
        if cut[u] or d < 0:
            part[u] = nxt
            nxt += 1
        else:
            part[u] = part[d]
    return part


def balanced_assignment(topo: RoutingTopology, n_dev: int) -> np.ndarray:
    """Rank assignment that SPLITS large basins with few cut edges.

    ``greedy_basin_assignment`` keeps basins whole, so one giant basin
    (the Mississippi is about half of CONUS) caps the gain at 2x.  Here
    the forest is first sliced into CONNECTED parts of size <= ~n/(4 *
    n_dev) by cutting tree edges (``tree_cut_parts``: a forest in P
    connected parts costs exactly P - n_basins cuts, the fewest
    possible), then the parts, ordered by first row (tree-adjacent parts
    are sequence-adjacent under the post-order row layout), are sliced
    into n_dev contiguous, load-balanced groups.  Neighbouring parts on
    one rank keep their shared edges local, so the cut count between
    ranks stays O(n_dev).
    """
    n = topo.n_nodes
    if n == 0:
        return np.zeros(0, np.int32)
    if n_dev <= 1:
        return np.zeros(n, np.int32)
    cap = max(1, -(-n // (4 * n_dev)))
    from troute_torch import native
    part = native.tree_cut_parts(topo.downstream, cap)
    if part is None:
        part = _tree_cut_parts_py(np.asarray(topo.downstream), cap)
    p_count = int(part.max()) + 1
    sizes = np.bincount(part, minlength=p_count).astype(np.int64)
    first_row = np.full(p_count, n, np.int64)
    np.minimum.at(first_row, part, np.arange(n))
    order = np.argsort(first_row, kind="stable")
    part_dev = np.zeros(p_count, np.int32)
    dev, load = 0, 0
    remaining, rem_dev = n, n_dev
    for p in order:
        s = int(sizes[p])
        target = remaining / rem_dev
        # close this rank when adding the part moves the load farther
        # from the running target than stopping short does
        if dev < n_dev - 1 and load > 0 \
                and (load + s) - target > target - load:
            remaining -= load
            rem_dev -= 1
            dev += 1
            load = 0
            target = remaining / rem_dev
        part_dev[p] = dev
        load += s
    return part_dev[part]

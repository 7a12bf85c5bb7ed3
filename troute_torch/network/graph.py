"""Host-side graph utilities on dict-of-lists river networks.

Functional equivalents of the reference's pure-Python DAG toolkit
(``troute-network/troute/nhd_network.py``): connection extraction,
reversal, headwater/tailwater identification, reachability, junction-break
reach decomposition, and waterbody node-collapse surgery.  These run once
at preprocessing time; the hot path never touches dicts (see
``topology.py`` for the array form the device consumes).

A *connections* dict maps ``node -> [downstream nodes]`` (at most one
downstream for river networks, but lists are supported throughout).  A
*reverse* dict maps ``node -> [upstream nodes]``.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Callable, Dict, Hashable, Iterable, List, Mapping, Sequence, Set


Connections = Dict[Hashable, List[Hashable]]


def extract_connections(ids: Sequence, downstreams: Sequence,
                        terminal_codes: Iterable = (0,)) -> Connections:
    """Build the downstream-connections dict from parallel id/downstream
    sequences, dropping links into terminal codes.

    Contract matches the reference loader (``nhd_network.py:26-53``
    produces the same mapping); implementation is a two-pass build —
    register every id as a key first, then append the surviving edges —
    so duplicate ids accumulate rather than overwrite.
    """
    drop = frozenset(terminal_codes)
    conn: Connections = {src: [] for src in ids}
    for src, dst in zip(ids, downstreams):
        if dst not in drop:
            conn[src].append(dst)
    return conn


def reverse_network(conn: Connections) -> Connections:
    """Upstream-connections dict; every node appears as a key.

    Two-pass edge inversion: the key set is fixed up front from both
    endpoints of every edge, then each edge is appended in the opposite
    direction.
    """
    rev: Connections = {n: [] for n in conn}
    for dsts in conn.values():
        for d in dsts:
            if d not in rev:
                rev[d] = []
    for src, dsts in conn.items():
        for d in dsts:
            rev[d].append(src)
    return rev


def headwaters(conn: Connections) -> Set:
    """Nodes with no upstream contributor (keys never appearing as values)."""
    seen = set()
    for dsts in conn.values():
        seen.update(dsts)
    return set(conn.keys()) - seen


def tailwaters(conn: Connections) -> Set:
    """Nodes that drain out of the network."""
    tw = set()
    for dsts in conn.values():
        tw.update(dsts)
    tw -= set(conn.keys())
    tw.update(n for n, dsts in conn.items() if not dsts)
    return tw


def reachable(rconn: Connections, sources: Iterable | None = None,
              targets: Iterable | None = None) -> Dict[Hashable, Set]:
    """BFS closure upstream of each source through the reverse graph."""
    if sources is None:
        sources = headwaters(rconn)
    targets = set(targets) if targets is not None else None
    out = {}
    for s in sources:
        seen = set()
        q = deque([s])
        while q:
            x = q.popleft()
            seen.add(x)
            if targets is None or x not in targets:
                q.extend(rconn.get(x, ()))
        out[s] = seen
    return out


def reachable_network(rconn: Connections, sources=None, targets=None,
                      check_disjoint: bool = True) -> Dict:
    """Split the reverse graph into independent sub-dicts keyed by tailwater."""
    closures = reachable(rconn, sources=sources, targets=targets)
    if check_disjoint and len(closures) > 1:
        union: Set = set()
        total = 0
        for c in closures.values():
            union |= c
            total += len(c)
        if total != len(union):
            raise ValueError("networks are not disjoint")
    return {tw: {n: rconn.get(n, []) for n in nodes}
            for tw, nodes in closures.items()}


def break_at_junction(rconn: Connections, gage_nodes: Set | None = None,
                      waterbody_nodes: Set | None = None
                      ) -> Callable[[List, Hashable], bool]:
    """Reach-continuation predicate: returns True if the walk may extend
    from ``path[-1]`` through ``node``.  Breaks at junctions, and (when
    supplied) when crossing gage nodes or waterbody boundaries — the
    reference's ``split_at_*`` family."""
    gages = gage_nodes or set()
    wbodies = waterbody_nodes or set()

    def ok(path: List, node: Hashable) -> bool:
        if gages and (path[-1] in gages or node in gages):
            return False
        if wbodies and ((path[-1] in wbodies) != (node in wbodies)):
            return False
        return len(rconn[node]) == 1
    return ok


def dfs_reach_decomposition(rconn: Connections,
                            keep_going: Callable[[List, Hashable], bool] | None = None,
                            sources: Iterable | None = None) -> List[List]:
    """Decompose the network into reaches — maximal simply-connected runs of
    nodes broken by junctions (or gages/waterbody edges via ``keep_going``).

    Returned reaches are ordered so every reach appears after all of its
    upstream reaches, and nodes within a reach run upstream→downstream —
    the same contract as the reference's ``dfs_decomposition``
    (``nhd_network.py:503-557``), yielding directly comparable outputs.

    Implementation (unlike the reference's DFS stack machine): a single
    downstream sweep in Kahn topological order.  Each node either extends
    the reach whose current tail is its sole upstream neighbour — when the
    continuation predicate admits the edge — or opens a new reach.  Reaches
    are created in head-topological order, which is a valid reach-level
    topological order because a reach's head only appears after every node
    upstream of it.
    """
    if keep_going is None:
        keep_going = break_at_junction(rconn)

    # flow-direction adjacency (invert the upstream dict)
    conn: Connections = {n: [] for n in rconn}
    for node, ups in rconn.items():
        for u in ups:
            conn.setdefault(u, []).append(node)

    if sources is not None:
        # restrict to the upstream closure of the requested outlets
        keep_nodes: Set = set()
        frontier = list(sources)
        while frontier:
            n = frontier.pop()
            if n in keep_nodes:
                continue
            keep_nodes.add(n)
            frontier.extend(rconn.get(n, ()))
        conn = {n: [d for d in dsts if d in keep_nodes]
                for n, dsts in conn.items() if n in keep_nodes}

    reaches: List[List] = []
    tail_reach: Dict[Hashable, int] = {}  # reach index currently ending at node
    for node in kahn_toposort(conn):
        ups = rconn.get(node, ())
        ri = tail_reach.get(ups[0]) if len(ups) == 1 else None
        if ri is not None and keep_going(reaches[ri], node):
            del tail_reach[ups[0]]
            reaches[ri].append(node)
        else:
            ri = len(reaches)
            reaches.append([node])
        tail_reach[node] = ri
    return reaches


def kahn_toposort(conn: Connections) -> List:
    """Topological order of all nodes (downstream direction)."""
    indeg = defaultdict(int)
    for n in conn:
        indeg[n]
    for dsts in conn.values():
        for d in dsts:
            indeg[d] += 1
    ready = deque(n for n, c in indeg.items() if c == 0)
    order = []
    while ready:
        n = ready.popleft()
        order.append(n)
        for d in conn.get(n, ()):
            indeg[d] -= 1
            if indeg[d] == 0:
                ready.append(d)
    if len(order) != len(indeg):
        raise ValueError("cycle detected in network")
    return order


def replace_waterbodies(conn: Connections,
                        waterbodies: Mapping[Hashable, Hashable]):
    """Collapse each waterbody's segment footprint into a single lake node.

    ``waterbodies`` maps segment id -> lake id.  Returns ``(new_conn,
    lake_outlets)`` where lake nodes (keyed by lake id) inherit the
    footprint's outward edges and upstream fringe nodes are re-pointed at
    the lake node; ``lake_outlets`` maps lake id -> the footprint segment
    at the outlet (reference ``replace_waterbodies_connections``,
    ``nhd_network.py:637-689``).
    """
    lake_members: Dict[Hashable, Set] = defaultdict(set)
    for seg, lake in waterbodies.items():
        lake_members[lake].add(seg)

    new_conn: Connections = {}
    lake_outlets: Dict[Hashable, Hashable] = {}

    for lake, members in lake_members.items():
        outgoing = []
        for seg in members:
            for d in conn.get(seg, ()):
                if d not in waterbodies:
                    outgoing.append(d)
                    lake_outlets[lake] = seg
        new_conn[lake] = outgoing

    for n, dsts in conn.items():
        if n in waterbodies:
            continue
        replaced = []
        for d in dsts:
            lake = waterbodies.get(d)
            if lake is not None:
                if lake not in replaced:
                    replaced.append(lake)
            else:
                replaced.append(d)
        new_conn[n] = replaced
    return new_conn, lake_outlets

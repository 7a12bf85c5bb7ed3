"""Synthetic CONUS-scale network and channel parameters.

The port's copy of ``synthetic_conus`` and ``channel_params`` of the JAX
package's benchmark (``bench.py:99-145``), with the same random streams,
so both packages build bit-identical inputs from one seed; the diffusive
benchmark's mainstem reach tree (``mainstem_tree``, ``bench.py:159-198``);
and writers
that put such a network on disk as the files the command line reads
without HDF5: a HYFeatures geopackage (``sqlite3``) and NEXOUT CSV
forcing.
"""

from __future__ import annotations

import numpy as np

CONUS_SEGMENTS = 2_729_077
CONUS_BASINS = 14_713


def synthetic_conus(n=CONUS_SEGMENTS, n_basins=CONUS_BASINS, span=4, seed=0):
    """Synthetic CONUS drainage forest: (ids, downstream ids), 0 marking a
    tailwater.

    Basin sizes follow the real skew: the Mississippi drains ~45% of CONUS
    segments and a handful of other majors another ~25%; the remaining
    ~14.7k coastal basins share the rest with lognormal sizes.  Within a
    basin, random forward hops of span <= 4 give ~32% headwaters and ~26%
    junction segments, bracketing the NWM NHD+ ratios (1.03M junctions in
    2.73M segments).
    """
    rng = np.random.default_rng(seed)
    ids = np.arange(1, n + 1, dtype=np.int64)
    idx = np.arange(n)
    majors = np.array([0.45, 0.06, 0.05, 0.035, 0.03, 0.02,
                       0.015, 0.012, 0.01, 0.008])
    sizes = (majors * n).astype(np.int64)
    n_small = n_basins - sizes.size
    small = rng.lognormal(0.0, 1.2, n_small)
    rest = n - sizes.sum()
    small = np.maximum((small / small.sum() * rest).astype(np.int64), 1)
    sizes = np.concatenate([sizes, small])
    sizes[-1] += n - sizes.sum()           # exact total
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    basin_of = np.searchsorted(bounds, idx, side="right") - 1
    basin_end = bounds[basin_of + 1] - 1
    hop = rng.integers(1, span + 1, n)
    j = np.minimum(idx + hop, basin_end)
    down = ids[j]
    down[idx == basin_end] = 0   # tailwaters
    return ids, down


def channel_params(n, rng):
    """Per-segment channel parameters (f32 arrays) drawn from ``rng``."""
    return dict(
        dx=rng.uniform(500, 3000, n).astype(np.float32),
        bw=rng.uniform(2, 20, n).astype(np.float32),
        tw=rng.uniform(25, 60, n).astype(np.float32),
        twcc=rng.uniform(80, 200, n).astype(np.float32),
        n=np.full(n, 0.055, np.float32),
        ncc=np.full(n, 0.11, np.float32),
        cs=rng.uniform(0.3, 1.5, n).astype(np.float32),
        s0=rng.uniform(0.001, 0.02, n).astype(np.float32))


def write_hyfeatures_geopackage(path, ids, down, chan, lakes=None,
                                gages=None) -> None:
    """The network (``ids``, downstream ``down`` with 0 a tailwater,
    channel parameters ``chan`` as from ``channel_params``) as a
    new-generation HYFeatures geopackage, the layout
    ``network/hyfeatures.py:read_geopkg`` reads: ``flowpaths`` (wb-<id> ->
    its downstream nexus), ``nexus`` (nex-<id> -> wb-<id>: every flowpath
    has the nexus that feeds it, shared by its upstream flowpaths),
    ``flowpath_attributes``, ``network`` (gage tags) and ``lakes``.

    ``lakes``: {lake id: (flowpath id, [LkArea, LkMxE, OrificeA, OrificeC,
    OrificeE, WeirC, WeirE, WeirL, ifd])}, each lake one flowpath;
    ``gages``: {flowpath id: USGS gage id (digits)}.
    """
    import sqlite3

    ids = np.asarray(ids, np.int64).tolist()
    down = np.asarray(down, np.int64).tolist()
    lakes, gages = lakes or {}, gages or {}
    lake_of = {int(seg): int(lk) for lk, (seg, _) in lakes.items()}
    wb = [f"wb-{i}" for i in ids]
    con = sqlite3.connect(path)
    try:
        con.execute("CREATE TABLE flowpaths (fid INTEGER, id TEXT, toid TEXT)")
        con.executemany(
            "INSERT INTO flowpaths VALUES (NULL, ?, ?)",
            zip(wb, (f"nex-{d}" if d else f"tnx-{i}"
                     for i, d in zip(ids, down))))
        con.execute("CREATE TABLE nexus "
                    "(fid INTEGER, id TEXT, toid TEXT, hl_uri TEXT)")
        con.executemany("INSERT INTO nexus VALUES (NULL, ?, ?, NULL)",
                        zip((f"nex-{i}" for i in ids), wb))
        con.execute(
            "CREATE TABLE flowpath_attributes (fid INTEGER, id TEXT,"
            " rl_NHDWaterbodyComID TEXT, MusK REAL, MusX REAL, n REAL,"
            " So REAL, ChSlp REAL, BtmWdth REAL, nCC REAL, TopWdthCC REAL,"
            " TopWdth REAL, length_m REAL)")
        cols = [np.asarray(chan[k], np.float64).tolist()
                for k in ("n", "s0", "cs", "bw", "ncc", "twcc", "tw", "dx")]
        con.executemany(
            "INSERT INTO flowpath_attributes VALUES "
            "(NULL, ?, ?, 3600, 0.2, ?, ?, ?, ?, ?, ?, ?, ?)",
            zip(wb, (str(lake_of[i]) if i in lake_of else None for i in ids),
                *cols))
        con.execute("CREATE TABLE network "
                    "(fid INTEGER, id TEXT, hl_uri TEXT, hydroseq REAL)")
        con.executemany(
            "INSERT INTO network VALUES (NULL, ?, ?, ?)",
            ((f"wb-{seg}", f"Gages-{g}", float(k))
             for k, (seg, g) in enumerate(gages.items())))
        con.execute(
            "CREATE TABLE lakes (fid INTEGER, id TEXT, hl_link REAL,"
            " LkArea REAL, LkMxE REAL, OrificeA REAL, OrificeC REAL,"
            " OrificeE REAL, WeirC REAL, WeirE REAL, WeirL REAL, ifd REAL,"
            " Dam_Length REAL)")
        con.executemany(
            "INSERT INTO lakes VALUES (NULL, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?,"
            " 10.0)",
            ((f"wb-{seg}", float(lk), *[float(v) for v in parms])
             for lk, (seg, parms) in lakes.items()))
        con.commit()
    finally:
        con.close()


def write_nexout_csv(path, ids, values) -> None:
    """One NEXOUT forcing file: the discharge ``values`` of the nexuses
    ``nex-<id>`` of ``write_hyfeatures_geopackage``, one row per nexus
    under a header line, as ``hyfeatures.py:read_qlat_nexout`` reads it."""
    import pandas as pd

    pd.DataFrame({"q": np.asarray(values, np.float32)},
                 index=pd.Index(np.asarray(ids, np.int64),
                                name="feature_id")).to_csv(path)


def mainstem_tree(n_reaches: int, n_nodes: int, seed: int = 2,
                  nts: int = 24, dt: float = 300.0):
    """The JAX package's diffusive benchmark domain (``bench.py:159-198``):
    a binary tree of ``n_reaches`` reaches of ``n_nodes`` nodes (reach j
    drains to (j - 1) // 2, reach 0 is the tailwater), 1,500 m nodes on a
    0.0005 slope, random widths from ``seed``'s stream, lateral inflow
    0.05 per node and tributary inflow at the heads, 20-80 at the leaves.
    Returns ``build_domain``'s positional arguments: (reaches, ds_reach,
    qlat [nts + 2, R, C], dt_qlat, trib [nts + 2, R], dt_trib, dtini)."""
    rng = np.random.default_rng(seed)
    n_t = nts + 2
    level = np.zeros(n_reaches, np.int64)
    ds_reach = np.full(n_reaches, -1, np.int64)
    for j in range(1, n_reaches):
        ds_reach[j] = (j - 1) // 2
        level[j] = level[ds_reach[j]] + 1
    dx = 1500.0
    s0 = 0.0005
    reaches = []
    for j in range(n_reaches):
        z_head = (level[j] + 1) * n_nodes * dx * s0
        z = z_head - s0 * dx * np.arange(n_nodes)
        ones = np.ones(n_nodes)
        reaches.append(dict(
            z=z, dx=np.full(n_nodes, dx),
            bo=rng.uniform(15, 40) * ones, traps=ones.copy(),
            tw=rng.uniform(60, 120) * ones, twcc=rng.uniform(200, 400) * ones,
            mann=0.035 * ones, manncc=0.07 * ones))
    qlat = np.full((n_t, n_reaches, n_nodes), 0.05)
    trib = np.full((n_t, n_reaches), 2.0)
    leaves = np.setdiff1d(np.arange(n_reaches), ds_reach)
    trib[:, leaves] = rng.uniform(20, 80, leaves.size)
    return reaches, ds_reach, qlat, dt, trib, dt, dt


def regional_network(n: int, n_basins: int, seed: int):
    """A regional drainage network: ``n`` segments in ``n_basins`` basins
    of equal size, each wired by ``synthetic_conus``'s hop rule (a forward
    hop of 1-4 segments within the basin, its last segment the
    tailwater).  Returns (ids, downstream ids), 0 marking a tailwater."""
    rng = np.random.default_rng(seed)
    ids = np.arange(1, n + 1, dtype=np.int64)
    idx = np.arange(n)
    size = -(-n // n_basins)
    basin_end = np.minimum((idx // size + 1) * size, n) - 1
    down = ids[np.minimum(idx + rng.integers(1, 5, n), basin_end)]
    down[idx == basin_end] = 0
    return ids, down


def hybrid_regional(n: int, n_basins: int, n_trees: int, seed: int = 11,
                    reaches=(48, 64), n_coastal: int = 2):
    """``regional_network`` as an in-memory RouteLink domain whose first
    ``n_trees`` basins each carry a diffusive mainstem: the trunk up the
    largest subtree from the basin's tailwater.  Tributaries join the
    trunk at every J-th trunk segment only (J drawn from 6-10 per tree;
    the segments that hopped onto the trunk in between drain to the next
    such junction downstream), so a junction-broken reach (a new reach at
    each trunk segment whose full-network in-degree is not 1, as
    ``routing/hybrid.py:HybridDomain._build`` splits them) is J segments
    long; the trunk is cut where it has opened its drawn number of
    reaches.  Mainstem segments get lowland river channels (bottom width
    ~3 sqrt(Q) for a steady lateral inflow of 1 m3/s per upstream segment,
    slope 2e-5 to 2e-4, so the mainstem lies within ~100 m of its
    tailwater's datum, as a coastal mainstem does); bed altitudes fall
    downstream at each segment's slope everywhere.

    Returns a dict: 'rl' (``io.routelink.RouteLinkData``), 'domain'
    ({tailwater: {"links": [...]}}, the diffusive-domain YAML's content),
    'topobathy' (a HYFeatures-parquet frame of natural sections, ``hy_id``
    wb-<id>, for the links of every other tree), 'coastal' ({tailwater:
    hourly depth series} for the first ``n_coastal`` trees) and
    'tailwaters'."""
    import pandas as pd

    from troute_torch.io.routelink import RouteLinkData

    ids, down = regional_network(n, n_basins, seed)
    rng = np.random.default_rng(seed + 1)
    chan = channel_params(n, rng)

    def children(down):
        key = np.where(down > 0, down - 1, n)     # ids are 1..n in order
        order = np.argsort(key, kind="stable")
        return order, np.searchsorted(key[order], np.arange(n + 1))

    order, starts = children(down)
    size = np.ones(n, np.int64)
    for i in range(n):                    # hops go forward: upstream first
        if down[i] > 0:
            size[down[i] - 1] += size[i]
    tailwaters = [int(ids[k]) for k in np.flatnonzero(down == 0)[:n_trees]]
    trunks = []
    for tw in tailwaters:
        trunk, k = [], tw - 1
        while True:
            trunk.append(k)
            kids = order[starts[k]:starts[k + 1]]
            if kids.size == 0:
                break
            k = int(kids[np.argmax(size[kids])])
        trunk = np.asarray(trunk)
        every = int(rng.integers(6, 11))
        junction = trunk[::every]
        on_trunk = np.zeros(n, bool)
        on_trunk[trunk] = True
        for i, t in enumerate(trunk):
            if i % every == 0:
                continue
            kids = order[starts[t]:starts[t + 1]]
            down[kids[~on_trunk[kids]]] = ids[junction[i // every]]
        trunks.append(trunk)
    indeg = np.bincount(down[down > 0] - 1, minlength=n)
    domain = {}
    for tw, trunk in zip(tailwaters, trunks):
        want = int(rng.integers(reaches[0], reaches[1] + 1))
        opened = np.cumsum(indeg[trunk] != 1)
        cut = int(np.searchsorted(opened, want)) + 1
        # a river, not a creek: the mainstem ends where the trunk drains
        # less than a tenth of its basin
        cut = min(cut, int(np.sum(size[trunk] >= size[trunk[0]] // 10)))
        domain[tw] = {"links": [int(ids[k]) for k in trunk[:cut]]}
    ms = np.asarray([s for v in domain.values() for s in v["links"]]) - 1
    m = ms.size
    # hydraulic geometry: bottom width ~ 3 sqrt(Q) for the flow of a
    # steady lateral inflow of 1 m3/s per segment upstream
    width = np.clip(3.0 * np.sqrt(size[ms]), 5.0, 120.0)
    chan["bw"][ms] = width * rng.uniform(0.8, 1.2, m)
    chan["tw"][ms] = chan["bw"][ms] * rng.uniform(1.3, 1.8, m)
    chan["twcc"][ms] = chan["tw"][ms] * rng.uniform(3.0, 6.0, m)
    chan["n"][ms] = 0.035
    chan["ncc"][ms] = 0.07
    chan["s0"][ms] = rng.uniform(2e-5, 2e-4, m)
    alt = np.zeros(n, np.float32)
    for i in range(n - 1, -1, -1):        # downstream first
        base = alt[down[i] - 1] if down[i] > 0 else 1.0
        alt[i] = base + chan["s0"][i] * chan["dx"][i]
    rl = RouteLinkData(ids=ids, downstream=down, channel=chan,
                       waterbody=np.full(n, -9999, np.int64),
                       waterbody_null=-9999,
                       gages=np.full(n, "", dtype=object), alt=alt)

    # natural sections: 9 points, the floor at the link's altitude
    shape = np.array([1.0, 0.75, 0.4, 0.15, 0.0, 0.12, 0.35, 0.7, 1.05])
    rows = []
    for tw in tailwaters[1::2]:
        for s in domain[tw]["links"]:
            width = float(chan["tw"][s - 1]) * rng.uniform(1.0, 1.5)
            depth = rng.uniform(3.0, 6.0)
            x = np.linspace(0.0, width, 9)
            z = alt[s - 1] + depth * shape
            rows += [(f"wb-{s}", xi, zi, 0.035) for xi, zi in zip(x, z)]
    topobathy = pd.DataFrame(rows, columns=["hy_id", "xid_d", "z", "n"])
    hours = np.arange(30)
    coastal = {tw: 2.5 + 0.8 * np.sin(hours / 3.0 + k)
               for k, tw in enumerate(tailwaters[:n_coastal])}
    return dict(rl=rl, domain=domain, topobathy=topobathy, coastal=coastal,
                tailwaters=tailwaters)

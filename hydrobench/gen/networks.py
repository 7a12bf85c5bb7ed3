"""Network generators of the benchmark, frozen here so that a change to
the program's own generators (``troute_torch/synthetic.py``,
``chip_smoke.py``) cannot move the yardstick.

``synthetic_conus`` and ``channel_params`` are copies of the port's
functions of the same names (bit-identical streams for one seed);
``conus_lakes`` places level-pool lakes as ``chip_smoke.py`` places them on
its command-line domain, and ``bmi_pushes`` builds the arrays a NextGen
coupler pushes through the routing BMI, on ``synthetic_conus``'s network
at one VPU's size (its basin-size skew kept), with the segments pushed in
an order drawn from the seed.  A lake's initial water elevation is NWM's
level-pool start, ``OrificeE + ifd * (LkMxE - OrificeE)``.  Everything is
host NumPy; nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

# level-pool parameters of every synthetic lake after its area:
# LkMxE, OrificeA, OrificeC, OrificeE, WeirC, WeirE, WeirL, ifd
LAKE_FIXED = (12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 0.9)
LAKE_COLUMNS = ("LkArea", "LkMxE", "OrificeA", "OrificeC", "OrificeE",
                "WeirC", "WeirE", "WeirL", "ifd")
CHANNEL_KEYS = ("dx", "bw", "tw", "twcc", "n", "ncc", "cs", "s0")


def synthetic_conus(n: int, n_basins: int, span: int = 4, seed: int = 0):
    """Synthetic CONUS drainage forest: (ids 1..n, downstream ids), 0
    marking a tailwater.  Ten major basins hold fixed shares of the
    segments (the Mississippi 45%), the other basins lognormal sizes;
    within a basin each segment hops 1..``span`` segments forward."""
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
    sizes[-1] += n - sizes.sum()
    bounds = np.concatenate([[0], np.cumsum(sizes)])
    basin_of = np.searchsorted(bounds, idx, side="right") - 1
    basin_end = bounds[basin_of + 1] - 1
    hop = rng.integers(1, span + 1, n)
    j = np.minimum(idx + hop, basin_end)
    down = ids[j]
    down[idx == basin_end] = 0
    return ids, down


def channel_params(n: int, rng) -> dict:
    """Per-segment Muskingum-Cunge channel parameters, float32."""
    return dict(
        dx=rng.uniform(500, 3000, n).astype(np.float32),
        bw=rng.uniform(2, 20, n).astype(np.float32),
        tw=rng.uniform(25, 60, n).astype(np.float32),
        twcc=rng.uniform(80, 200, n).astype(np.float32),
        n=np.full(n, 0.055, np.float32),
        ncc=np.full(n, 0.11, np.float32),
        cs=rng.uniform(0.3, 1.5, n).astype(np.float32),
        s0=rng.uniform(0.001, 0.02, n).astype(np.float32))


def lake_table(area: np.ndarray) -> np.ndarray:
    """[n_lakes, 9] level-pool parameters in ``LAKE_COLUMNS`` order."""
    out = np.empty((area.size, len(LAKE_COLUMNS)), np.float64)
    out[:, 0] = area
    out[:, 1:] = LAKE_FIXED
    return out


def initial_elevation(table: np.ndarray) -> np.ndarray:
    """NWM's level-pool start: ``OrificeE + ifd * (LkMxE - OrificeE)``."""
    return table[:, 4] + (table[:, 1] - table[:, 4]) * table[:, 8]


def conus_lakes(ids: np.ndarray, down: np.ndarray, per_segments: int, rng):
    """About ``n // per_segments`` level-pool lakes on segments that have
    both an upstream and a downstream segment, less those that drain
    straight into another lake (no outlet segment).  Returns (lake
    segment indices, ascending; their [n_lakes, 9] parameter table)."""
    n = ids.size
    inner = ids[np.isin(ids, down) & (down > 0)]
    segs = rng.choice(inner, n // per_segments, replace=False)
    segs = segs[~np.isin(down[segs - 1], segs)]
    area = rng.uniform(1.0, 3.0, segs.size)
    order = np.argsort(segs)
    return segs[order] - 1, lake_table(area[order])


def conus_network(net: dict, seed: int) -> dict:
    """The CONUS deployment's network from ``seed``: ids, downstream ids,
    channel parameters (benign 1.0 on lake rows, as the command line's
    builder sets them), lake rows and their parameters, all in segment
    index order."""
    ids, down = synthetic_conus(net["segments"], net["basins"],
                                net.get("span", 4), seed=seed)
    rng = np.random.default_rng([seed, 1])
    chan = channel_params(ids.size, rng)
    lakes, table = conus_lakes(ids, down, net["lake_per_segments"], rng)
    for k in CHANNEL_KEYS:
        chan[k][lakes] = 1.0
    return dict(ids=ids, down=down, chan=chan, lakes=lakes,
                lake_params=table)


def bmi_pushes(net: dict, seed: int) -> dict:
    """``synthetic_conus``'s network at ``net['segments']`` segments in
    ``net['basins']`` basins, as the arrays a NextGen coupler pushes
    through ``set_value``: segments in an order drawn from the seed, then
    about one level-pool lake per ``net['lake_per_segments']`` segments,
    each between a segment and that segment's downstream segment (the
    segment drains into the lake, the lake into the segment's old
    downstream)."""
    ids, down = synthetic_conus(net["segments"], net["basins"],
                                net.get("span", 4), seed=seed)
    rng = np.random.default_rng([seed, 1])
    chan = channel_params(ids.size, rng)
    n_lakes = ids.size // net["lake_per_segments"]
    seg = rng.choice(np.flatnonzero(down > 0), n_lakes, replace=False)
    lakes = net.get("lake_id_base", 20_000_000) + np.arange(n_lakes,
                                                          dtype=np.int64)
    toid = down.copy()
    toid[seg] = lakes
    table = lake_table(rng.uniform(1.0, 3.0, n_lakes))
    perm = rng.permutation(ids.size)
    v = dict(segment_id=ids[perm], segment_toid=toid[perm],
             waterbody_id=lakes, waterbody_toid=down[seg],
             h0=initial_elevation(table), qd0=np.zeros(n_lakes))
    for name, col in zip(LAKE_COLUMNS, table.T):
        v[name] = col.copy()
    for k in CHANNEL_KEYS:
        v[k] = chan[k][perm]
    return v

"""Synthetic CONUS-scale network and channel parameters.

The port's copy of ``synthetic_conus`` and ``channel_params`` of the JAX
package's benchmark (``bench.py:99-145``), with the same random streams,
so both packages build bit-identical inputs from one seed.
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

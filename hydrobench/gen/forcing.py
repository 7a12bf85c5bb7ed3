"""The benchmark's one traffic generator: hourly lateral-inflow fields
from a traffic file's parameters and the seed.

A traffic file (``traffic/<name>.json``) holds:

* ``spinup_units``: units routed in set-up from the cell's initial
  state before the window (baseflow only);
* ``baseflow``: ``{"low", "high", "ring"}``, a ring of ``ring`` hourly
  fields, each uniform in [low, high) m3/s per segment;
* ``storm`` (or null): ``{"share", "rise", "recede", "peak_low",
  "peak_high"}``.  A storm covers a run of consecutive segments (whole
  basins but for its two ends) holding ``share`` of them; on it inflow
  rises linearly over ``rise`` hours to a per-segment peak drawn from
  [peak_low, peak_high) m3/s above the baseflow, then recedes linearly
  over ``recede`` hours; each storm is followed by a new one elsewhere.
  The window's ring then holds lcm(ring, rise + recede) hours;
* ``source`` and ``assumed``: the published statistic the magnitudes are
  set from, and what no source gives (read by no code).

Fields are made with one ``torch.Generator`` seeded from the seed, on the
device the driver names (the routing device, or the host where a coupler
hands NumPy arrays over), in segment index order.
"""

from __future__ import annotations

import math

import torch


def _generator(device, seed: int, stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    # the seed may exceed 64 bits' signed range only by being negative
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2 ** 63))
    return g


def baseflow_ring(traffic: dict, n: int, seed: int, device,
                  dtype=torch.float32) -> torch.Tensor:
    """[ring, n] hourly baseflow fields."""
    b = traffic["baseflow"]
    g = _generator(device, seed, 1)
    ring = torch.empty((b["ring"], n), dtype=dtype, device=device)
    ring.uniform_(b["low"], b["high"], generator=g)
    return ring


def storm_hours(traffic: dict) -> int:
    s = traffic["storm"]
    return int(s["rise"] + s["recede"])


def storm_factor(traffic: dict, hour: int) -> float:
    """Share of the peak that a storm adds in its ``hour``-th hour (0
    based; the value at the hour's end)."""
    s = traffic["storm"]
    t = hour % storm_hours(traffic) + 1
    if t <= s["rise"]:
        return t / s["rise"]
    return max(0.0, (storm_hours(traffic) - t) / s["recede"])


def window_ring(traffic: dict, base: torch.Tensor, seed: int
                ) -> torch.Tensor:
    """The window's hourly fields: ``base`` itself without a storm, else
    lcm(ring, storm length) fields of baseflow plus the storms."""
    if not traffic.get("storm"):
        return base
    s = traffic["storm"]
    n = base.shape[1]
    length = storm_hours(traffic)
    hours = math.lcm(base.shape[0], length)
    g = _generator(base.device, seed, 2)
    m = int(round(s["share"] * n))
    ring = torch.empty((hours, n), dtype=base.dtype, device=base.device)
    for k in range(hours // length):
        start = int(torch.randint(0, n - m + 1, (1,), generator=g,
                                  device=base.device))
        peak = torch.empty(m, dtype=base.dtype, device=base.device)
        peak.uniform_(s["peak_low"], s["peak_high"], generator=g)
        for j in range(length):
            h = k * length + j
            ring[h] = base[h % base.shape[0]]
            ring[h, start:start + m] += storm_factor(traffic, j) * peak
    return ring


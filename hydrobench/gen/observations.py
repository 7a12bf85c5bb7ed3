"""The benchmark's generator of data-assimilation inputs: which segments
carry gages and which lakes are assimilated, and each hour's gage
observations, persistence observations and RFC forecast series, from a
configuration's ``da`` block, a traffic file's ``observations`` block and
the seed.

A configuration's ``da`` block (the deployment) holds ``gages`` (gages on
segments that are no lake), ``decay_min`` (the nudging's decay),
``lake_every`` (``{"2": k2, "3": k3, "4": k4}``: one lake in k of each
DA type, 2 USGS and 3 USACE persistence, 4 RFC forecast; the rest level
pool), ``lookback_hours`` and ``obs_every_s`` (the persistence
observations' table), and ``rfc_lookback_hours``,
``rfc_forecast_hours``, ``rfc_step_s`` and ``rfc_persist_days`` (the RFC
series).

A traffic file's ``observations`` block (what arrives) holds ``ring``
(hours of observations made, reused in turn), ``da_spinup_units`` (hours
routed with DA from a cold DA state before the window, after the
traffic's ``spinup_units`` without it), ``gage_missing`` (the share of
gage-hours with no observation at all), ``lake_missing`` (the share of
persistence observations missing), and ``factor_low``/``factor_high``: a
reported value is a base flow times a factor uniform in [low, high),
drawn for each gage-hour, each persistence observation and each RFC
value.  The base flows are the program's flows after the spin-up without
DA: the gage segment's flow, the lake's outflow.

Choices are made on the host with NumPy from the seed; tables are made on
the routing device with one ``torch.Generator`` per kind, in the
reference's order (gages as chosen, lakes ascending by row).
"""

from __future__ import annotations

import numpy as np
import torch

from hydrobench.gen.forcing import _generator


def choose_gages(n: int, lakes: np.ndarray, count: int, seed: int
                 ) -> np.ndarray:
    """``count`` segment indices, ascending, drawn among those that are no
    lake."""
    rng = np.random.default_rng([seed, 7])
    free = np.setdiff1d(np.arange(n), lakes)
    if count > free.size:
        raise ValueError(f"{count} gages on {free.size} free segments")
    return np.sort(rng.choice(free, count, replace=False))


def lake_types(n_lakes: int, every: dict, seed: int) -> np.ndarray:
    """[n_lakes] int32 DA types: for each type t of ``every``, one lake in
    ``every[t]`` (at least one), the lakes drawn from the seed; 1 (level
    pool) for the rest."""
    rng = np.random.default_rng([seed, 8])
    order = rng.permutation(n_lakes)
    out = np.ones(n_lakes, np.int32)
    at = 0
    for t in sorted(every, key=int):
        k = max(1, int(round(n_lakes / every[t])))
        out[order[at:at + k]] = int(t)
        at += k
    return out


def _factors(g, shape, obs: dict, like: torch.Tensor) -> torch.Tensor:
    f = torch.empty(shape, dtype=like.dtype, device=like.device)
    return f.uniform_(obs["factor_low"], obs["factor_high"], generator=g)


def _missing(g, shape, share: float, like: torch.Tensor) -> torch.Tensor:
    u = torch.empty(shape, dtype=torch.float32, device=like.device)
    return u.uniform_(0.0, 1.0, generator=g) < share


def gage_ring(obs: dict, base: torch.Tensor, steps: int, seed: int
              ) -> torch.Tensor:
    """[ring, steps + 1, G] gage observations, row t at step t of its hour:
    each gage-hour one value for all its steps, or NaN for all of them."""
    g = _generator(base.device, seed, 11)
    shape = (obs["ring"], base.shape[0])
    val = base[None, :] * _factors(g, shape, obs, base)
    val = torch.where(_missing(g, shape, obs["gage_missing"], base),
                      float("nan"), val)
    return val[:, None, :].expand(-1, steps + 1, -1).contiguous()


def obs_times(da: dict, hour_s: float, like: torch.Tensor) -> torch.Tensor:
    """[n_obs] persistence observation times, s from an hour's start: every
    ``obs_every_s`` over the ``lookback_hours`` that end with the hour."""
    n = int(round(da["lookback_hours"] * 3600.0 / da["obs_every_s"])) + 1
    t = torch.arange(n, dtype=torch.float64, device=like.device)
    return (hour_s - (n - 1 - t) * da["obs_every_s"]).to(like.dtype)


def persistence_ring(obs: dict, da: dict, base: torch.Tensor,
                     assimilated: torch.Tensor, hour_s: float, seed: int
                     ) -> torch.Tensor:
    """[ring, L, n_obs] persistence observations (``obs_times``) of the
    lakes where ``assimilated``, NaN elsewhere and where missing."""
    g = _generator(base.device, seed, 12)
    n = obs_times(da, hour_s, base).shape[0]
    shape = (obs["ring"], base.shape[0], n)
    val = base[None, :, None] * _factors(g, shape, obs, base)
    gone = _missing(g, shape, obs["lake_missing"], base) \
        | ~assimilated[None, :, None]
    return torch.where(gone, float("nan"), val)


def rfc_counts(da: dict) -> int:
    """Values one RFC series holds: the lookback's, then the forecast's."""
    return int(da["rfc_lookback_hours"] + da["rfc_forecast_hours"])


def rfc_ring(obs: dict, da: dict, base: torch.Tensor,
             assimilated: torch.Tensor, seed: int) -> torch.Tensor:
    """[ring, L, n_counts] RFC series of the lakes where ``assimilated``
    (0 elsewhere), one issued at each hour's start."""
    g = _generator(base.device, seed, 13)
    shape = (obs["ring"], base.shape[0], rfc_counts(da))
    val = base[None, :, None] * _factors(g, shape, obs, base)
    return torch.where(assimilated[None, :, None], val, 0.0)

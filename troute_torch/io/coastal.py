"""Coastal downstream-boundary input readers.

Port of ``troute_tpu/io/coastal.py`` (NumPy, pandas and YAML; the NetCDF
read goes through the port's ``io/netcdf.py``, which needs ``h5py`` at the
call).  Reference: ``nhd_io.read_coastal_boundary_domain`` (nhd_io.py:186) and
``build_coastal_ncdf_dataframe`` (nhd_io.py:1687-1733) — water depth at
diffusive tailwater nodes from a SCHISM output file, used as the diffusive
solver's downstream boundary (dsbc_option == 1).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd
import yaml

from troute_torch.io.netcdf import NetCDFFile


def read_coastal_boundary_domain(path) -> dict:
    """{tailwater segment id: coastal model node index} from YAML/JSON.

    A file with a single ``coastal_hy_crosswalk`` key is the HYFeatures
    nexus crosswalk variant (AbstractNetwork.py:164-166); its inner mapping
    is returned.
    """
    with open(path) as f:
        data = yaml.safe_load(f)
    if isinstance(data, dict) and set(data) == {"coastal_hy_crosswalk"}:
        data = data["coastal_hy_crosswalk"]
    return {int(k): int(v) for k, v in data.items()}


def read_coastal_depth_series(nc_path, domain: dict):
    """Per-tailwater water-depth series from a SCHISM ``schout`` file.

    Depth = elev (NAVD88 surface) + bathymetric depth at the crosswalked
    node.  Mirrors ``build_coastal_ncdf_dataframe``: the series gains a
    leading column at the file's base date whose value is linearly
    extrapolated backward (``2*d1 - d2``, nhd_io.py:1733), and column t
    (t >= 1) holds elev[t-1] — i.e. SCHISM's time stamps label interval
    ends.

    Returns (start_time: pd.Timestamp, dt_sec: float,
    {tw_id: depth array [n_t+1]}).
    """
    nc_path = Path(nc_path)
    tws = list(domain.keys())
    nodes = np.asarray(list(domain.values()), np.int64)
    with NetCDFFile(nc_path) as f:
        elev = f.read("elev")[:, nodes]
        bathy = f.read("depth")[nodes]
        times = f.read("time")
        units = f.attrs("time")["units"]
    if times.size < 2:
        raise ValueError("coastal file provides fewer than 2 time steps")
    dt_sec = float(times[1] - times[0])
    # "seconds since YYYY-..." -> base date
    base = pd.to_datetime(str(units).split("since", 1)[1].strip()
                          .replace("+00:00", ""))
    depth = elev + bathy[None, :]                  # [n_t, n_tw]
    first = 2.0 * depth[0] - depth[1]              # backward extrapolation
    series = np.concatenate([first[None, :], depth], axis=0)
    return base, dt_sec, {tw: series[:, k] for k, tw in enumerate(tws)}


def coastal_db_for_domain(nc_path, domain_path, t0: pd.Timestamp,
                          tailwater_ids, n_reaches: int,
                          tw_reach_index: dict):
    """Assemble the [R, n_db] depth array + dt for ``build_domain``.

    Args:
        tailwater_ids: segment id of the bottom node per diffusive reach
            tree tailwater (keys expected in the crosswalk)
        tw_reach_index: {tailwater segment id: reach row in the domain}

    The series' time axis is re-based so index 0 lies at run start ``t0``
    (the solver's t = 0); coastal samples before t0 are dropped.  Returns
    (db_depth [R, n_db] with NaN rows for uncovered reaches, dt_db) or
    (None, None) when no tailwater is covered.
    """
    domain = read_coastal_boundary_domain(domain_path)
    wanted = {tw: node for tw, node in domain.items() if tw in tw_reach_index}
    if not wanted:
        return None, None
    base, dt_sec, series = read_coastal_depth_series(nc_path, wanted)
    offset = (t0 - base).total_seconds()
    # sample count covering from t0 on the file's grid
    skip = max(0, int(np.ceil(offset / dt_sec - 1e-9)))
    any_len = max(s.size - skip for s in series.values())
    if any_len < 2:
        return None, None
    out = np.full((n_reaches, any_len), np.nan)
    for tw, s in series.items():
        r = tw_reach_index[tw]
        # shift so column 0 is the sample at/after t0 (linear end
        # extrapolation in the solver covers the sub-dt residual)
        vals = s[skip:]
        out[r, :vals.size] = vals
    return out, dt_sec

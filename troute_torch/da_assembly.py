"""Great Lakes DA input assembly.

Reference ``DataAssimilation._create_GL_dfs`` (``DataAssimilation.py:2052``):
per-GL-lake gage observations from USGS / Canadian (WSC) TimeSlice files
plus the Lake Ontario outflow CSV, on a seconds-since-t0 time axis, with
the hardcoded monthly climatology as fallback.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from troute_torch.io.timeslice import read_timeslice_file
from troute_torch.network.gl_constants import climatology_for


def read_gl_gage_obs(files, gage_id: str, t0: pd.Timestamp):
    """(obs values, obs times in seconds since t0) for one gage, raw
    TimeSlice resolution (the GL DA searches raw observations; no
    interpolation — reference ``get_GL_obs_from_timeslices``)."""
    vals, times = [], []
    for f in files:
        try:
            df = read_timeslice_file(f)
        except (OSError, KeyError):
            continue
        sel = df[df["stationId"] == str(gage_id)]
        for _, row in sel.iterrows():
            q = row["discharge"]
            if np.isfinite(q) and q > 0 and row["quality"] >= 0:
                vals.append(float(q))
                t = (pd.to_datetime(row["datetime"],
                                    format="%Y-%m-%d_%H:%M:%S")
                     - t0).total_seconds()
                times.append(t)
    order = np.argsort(times)
    return (np.asarray(vals, np.float64)[order],
            np.asarray(times, np.float64)[order])


def read_lake_ontario_outflow(csv_path, t0: pd.Timestamp):
    """(values, seconds since t0) from the cleaned LakeOntario CSV
    (Date, Hour, Outflow columns)."""
    df = pd.read_csv(csv_path)
    # hours are sometimes recorded as "24:xx" (meaning next-day 00:xx);
    # add them as timedeltas instead of parsing a combined timestamp
    hm = df["Hour"].astype(str).str.split(":", expand=True).astype(float)
    when = pd.to_datetime(df["Date"].astype(str)) \
        + pd.to_timedelta(hm[0], unit="h") \
        + pd.to_timedelta(hm[1], unit="m")
    secs = (when - t0).dt.total_seconds().to_numpy(np.float64)
    vals = df.iloc[:, 2].to_numpy(np.float64)
    ok = np.isfinite(vals)
    order = np.argsort(secs[ok])
    return vals[ok][order], secs[ok][order]


def assemble_gl_inputs(lake_gages: dict, t0: pd.Timestamp,
                       usgs_files=(), canada_files=(),
                       lake_ontario_csv: str | Path | None = None):
    """Dense GL observation arrays per lake.

    Args:
        lake_gages: {lake_id: gage id} for GL lakes with TimeSlice gages

    Returns dict {lake_id: (obs [n], obs_time [n], climatology [12])}.
    """
    out = {}
    files = list(usgs_files) + list(canada_files)
    for lake_id, gage in lake_gages.items():
        clim = climatology_for(lake_id)
        if clim is None:
            continue
        vals, times = read_gl_gage_obs(files, gage, t0)
        out[int(lake_id)] = (vals, times, clim)
    if lake_ontario_csv is not None:
        clim = climatology_for(4800007)
        vals, times = read_lake_ontario_outflow(lake_ontario_csv, t0)
        out[4800007] = (vals, times, clim)
    return out

"""USGS/USACE TimeSlice observation reading, QC, and interpolation.

Equivalent of ``nhd_io.get_obs_from_timeslices`` (``nhd_io.py:1101-1250``):
read per-15-min TimeSlice NetCDFs, quality-screen, interpolate over gaps up
to a limit, and resample onto the routing timestep grid — producing the
dense [n_times, n_gages] observation array the DA ops consume.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from troute_torch.io.netcdf import NetCDFFile


def read_timeslice_file(path):
    """One TimeSlice file -> DataFrame(stationId, datetime, discharge, quality)."""
    with NetCDFFile(path) as f:
        stations = f.read_strings("stationId")
        times = f.read_strings("time")
        discharge = f.read("discharge").astype(np.float64)
        quality = f.read("discharge_quality").astype(np.float64) / 100.0
    return pd.DataFrame({
        "stationId": stations, "datetime": times,
        "discharge": discharge, "quality": quality})


def get_obs_from_timeslices(gage_ids: np.ndarray, timeslice_files,
                            qc_threshold: float = 1.0,
                            interpolation_limit: int = 59,
                            frequency_secs: float = 300.0,
                            t0: pd.Timestamp | None = None,
                            nts: int | None = None) -> pd.DataFrame:
    """Assemble a [gage, time] observation table on the routing time grid.

    QC rules per the reference: quality flags outside [0, 1] invalid;
    observations with quality < qc_threshold or value <= 0 removed;
    interpolation at 1-minute resolution limited to ``interpolation_limit``
    minutes, then resampled to ``frequency_secs``.

    Returns a DataFrame indexed by gage id with datetime columns.
    """
    frames = []
    for f in timeslice_files:
        try:
            frames.append(read_timeslice_file(f))
        except (OSError, KeyError):
            continue
    if not frames:
        return pd.DataFrame()
    df = pd.concat(frames)
    df = df[df["stationId"].isin(np.asarray(gage_ids).astype(str))]
    if df.empty:
        return pd.DataFrame()

    qual = df.pivot_table(index="stationId", columns="datetime",
                          values="quality", aggfunc="last")
    obs = df.pivot_table(index="stationId", columns="datetime",
                         values="discharge", aggfunc="last")
    qual = qual.mask((qual < 0) | (qual > 1))
    obs = obs.mask(qual < qc_threshold).mask(obs <= 0)

    obs_t = obs.T
    obs_t.index = pd.to_datetime(obs_t.index, format="%Y-%m-%d_%H:%M:%S")
    obs_t = obs_t.sort_index()
    freq = f"{int(frequency_secs / 60)}min"
    interp = (obs_t.resample("min").asfreq()
              .interpolate(limit=int(interpolation_limit),
                           limit_direction="both")
              .resample(freq).asfreq())
    out = interp.T
    if t0 is not None and nts is not None:
        cols = pd.date_range(t0, periods=nts + 1,
                             freq=pd.Timedelta(seconds=frequency_secs))
        out = out.reindex(columns=cols)
    return out


def build_obs_array(obs_df: pd.DataFrame, gage_rows: dict,
                    n_gages: int, nts: int) -> np.ndarray:
    """[nts+1, n_gages] array aligned with engine timesteps (NaN missing)."""
    if len(obs_df) > n_gages:
        raise ValueError(
            f"observation table has {len(obs_df)} gage rows but the gage "
            f"crosswalk provisioned only {n_gages}; refusing to silently "
            f"drop observations — check the gage/crosswalk alignment "
            f"(extra rows start at {list(obs_df.index[n_gages:n_gages + 5])})")
    arr = np.full((nts + 1, n_gages), np.nan, np.float32)
    for gi, (gage, row) in enumerate(obs_df.iterrows()):
        vals = row.to_numpy(np.float64)[:nts + 1]
        arr[:vals.size, gi] = vals
    return arr

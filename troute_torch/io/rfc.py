"""RFC forecast time-series discovery and preprocessing.

Reference: ``fast_reach/reservoir_RFC_da.py:preprocess_RFC_data`` — find the
newest RFCTimeSeries file looking back hourly from (t0 + offset hours),
then derive the starting series index and update time.

Validation quirk preserved: the reference's negative-value and
extreme-value checks are inert (``any(series) < 0`` compares a bool), so
the effective conditions are all-synthetic, file-missing, and
routing-period > 1 hour.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from troute_torch.io.netcdf import NetCDFFile

MAX_SEARCH_HOURS = 28


def preprocess_rfc_data(t0: pd.Timestamp, offset_hours: int, gage_id: str,
                        folder: Path, routing_period: float):
    """Locate + load the RFC series for one gage.

    Returns dict(use_rfc, series, total_counts, timeseries_idx,
    update_time, time_step_seconds, file) or None if no file found.
    """
    folder = Path(folder)
    offset_date = (t0 + pd.Timedelta(hours=offset_hours)).floor("h")
    path = None
    lookback_hours = 0
    for hour in range(MAX_SEARCH_HOURS):
        stamp = (offset_date - pd.Timedelta(hours=hour)).strftime(
            "%Y-%m-%d_%H")
        cand = folder / f"{stamp}.60min.{gage_id}.RFCTimeSeries.ncdf"
        if cand.exists():
            path = cand
            lookback_hours = hour
            break
    if path is None:
        return None

    with NetCDFFile(path) as f:
        series = np.asarray(f.read("discharges"), np.float64).ravel()
        synthetic = np.asarray(f.raw("synthetic_values")).ravel()
        total_counts = int(np.asarray(f.raw("totalCounts")).ravel()[0])
        observed_counts = int(np.asarray(f.raw("observedCounts")).ravel()[0])
        ts_raw = np.asarray(f.raw("timeSteps")).ravel()[0]
        time_step_seconds = int(ts_raw)

    lookback_seconds = lookback_hours * 3600
    timeseries_idx = int(lookback_seconds / time_step_seconds
                         + observed_counts - offset_hours)
    update_offset = lookback_seconds % time_step_seconds
    update_time = float(time_step_seconds - update_offset)

    use_rfc = (not bool(np.all(synthetic == 1))
               and routing_period <= 3600.0)
    return dict(use_rfc=use_rfc, series=series, total_counts=total_counts,
                timeseries_idx=timeseries_idx, update_time=update_time,
                time_step_seconds=time_step_seconds, file=str(path))

"""Warm-state (restart) I/O.

Three warm-start paths matching the reference (``AbstractNetwork.py:673-735``):
lite restart (pickled frames, ``nhd_io.write_lite_restart:1458``), WRF-Hydro
HYDRO_RST NetCDF (``nhd_io.get_channel_restart_from_wrf_hydro:1368``), and
cold start.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from troute_torch.io.netcdf import NetCDFFile


def read_wrf_hydro_channel_restart(restart_file, routelink_file,
                                   crosswalk_link_field="link"):
    """Channel warm state from a HYDRO_RST file.

    The restart carries no ids; rows align positionally with the RouteLink
    file order (reference ``get_channel_restart_from_wrf_hydro`` — "the
    order is simply the same as that found in the Route-Link files", NOT
    the CHRTOUT order).  Returns (ids, qu0, qd0, h0).
    """
    with NetCDFFile(routelink_file) as f:
        ids = f.read(crosswalk_link_field).astype(np.int64)
    with NetCDFFile(restart_file) as f:
        qlink1 = f.read("qlink1").astype(np.float32)   # flow into segment
        qlink2 = f.read("qlink2").astype(np.float32)   # flow out of segment
        hlink = f.read("hlink").astype(np.float32)     # depth
    m = min(ids.size, qlink1.size)
    return ids[:m], qlink1[:m], qlink2[:m], hlink[:m]


def read_wrf_hydro_waterbody_restart(restart_file, lakeparm_file,
                                     lake_id_field="lake_id"):
    """Waterbody warm state (elevation, outflow) from HYDRO_RST.

    Returns (lake_ids, water_elevation, outflow).
    """
    with NetCDFFile(lakeparm_file) as f:
        lake_ids = f.read(lake_id_field).astype(np.int64)
        if "ascendingIndex" in f.variables:
            order = np.argsort(f.read("ascendingIndex").astype(np.int64))
            lake_ids = lake_ids[order]
    with NetCDFFile(restart_file) as f:
        resht = f.read("resht").astype(np.float32)
        qlakeo = f.read("qlakeo").astype(np.float32)
    m = min(lake_ids.size, resht.size)
    return lake_ids[:m], resht[:m], qlakeo[:m]


def write_lite_restart(path_prefix, timestamp, q0_df, waterbody_df):
    """Write lite channel/waterbody restarts (pickled DataFrames, matching
    the reference's format so runs can resume across frameworks).

    The reference (``nhd_io.write_lite_restart``, nhd_io.py:1480-1500)
    stamps both frames with a ``time`` column that its reader requires
    (``read_lite_restart`` does ``df['time'].iloc[0]``, nhd_io.py:1453);
    add it here so t-route can consume these files.
    """
    ts = timestamp.strftime("%Y%m%d%H%M")
    chan_path = Path(str(path_prefix)) / f"channel_restart_{ts}"
    wb_path = Path(str(path_prefix)) / f"waterbody_restart_{ts}"
    q0_df = q0_df.copy()
    q0_df["time"] = timestamp
    with open(chan_path, "wb") as f:
        pickle.dump(q0_df, f)
    if waterbody_df is not None:
        waterbody_df = waterbody_df.copy()
        waterbody_df["time"] = timestamp
        with open(wb_path, "wb") as f:
            pickle.dump(waterbody_df, f)
    return chan_path, wb_path


def read_lite_restart(path):
    """Read a lite restart pickle -> DataFrame."""
    with open(path, "rb") as f:
        return pickle.load(f)


def read_lastobs_file(path):
    """Warm-start lastobs state (reference nudgingLastObs format).

    Returns (gage_ids [n], lastobs_discharge [n], lastobs_time_offset [n])
    where the time offset is seconds relative to the file's model time
    (non-positive: observations were at or before the output time).
    """
    import pandas as pd

    from troute_torch.io.netcdf import NetCDFFile

    with NetCDFFile(path) as f:
        gages = f.read_strings("stationId")
        discharge = np.asarray(f.read("discharge"), np.float64)
        times = f.raw("time")
        model_time = f.attrs().get("modelTimeAtOutput", "")
    if discharge.ndim > 1:
        discharge = discharge[:, -1]
    obs_times = []
    t0 = pd.to_datetime(str(model_time), format="%Y-%m-%d_%H:%M:%S")
    for row in times:
        s = b"".join(row.ravel()).decode("utf-8", "replace").strip()
        try:
            obs_times.append((pd.to_datetime(
                s, format="%Y-%m-%d_%H:%M:%S") - t0).total_seconds())
        except ValueError:
            obs_times.append(np.nan)
    return (np.asarray(gages), discharge,
            np.asarray(obs_times, np.float64))


def append_hydro_rst(restart_files, out_ids, fvd, t0, dt,
                     crosswalk_file):
    """Append t-route flows/depths into existing WRF-Hydro HYDRO_RST files.

    For each restart file whose ``Restart_Time`` falls on a simulated
    timestep, add ``qlink1_troute``/``qlink2_troute``/``hlink_troute``
    variables ordered by the RouteLink file's positional link order
    (reference ``nhd_io.write_hydro_rst``, nhd_io.py:1507-1618).

    Returns the list of files written.
    """
    import h5py
    import pandas as pd

    from troute_torch.io.netcdf import NetCDFFile

    with NetCDFFile(crosswalk_file) as f:
        order = f.read("link").astype(np.int64)
    row_of = {int(s): k for k, s in enumerate(out_ids)}
    rows = np.asarray([row_of.get(int(s), -1) for s in order], np.int64)
    have = rows >= 0

    times = t0 + pd.to_timedelta((np.arange(fvd.shape[0]) + 1) * dt,
                                 unit="s")
    stamp_idx = {t.strftime("%Y-%m-%d_%H:%M:%S"): k
                 for k, t in enumerate(times)}
    written = []
    for path in restart_files:
        with h5py.File(path, "a") as f:
            stamp = f.attrs.get("Restart_Time", b"")
            if isinstance(stamp, bytes):
                stamp = stamp.decode()
            k = stamp_idx.get(str(stamp))
            if k is None:
                continue
            q = np.zeros(order.size, np.float32)
            h = np.zeros(order.size, np.float32)
            q[have] = fvd[k, rows[have], 0]
            h[have] = fvd[k, rows[have], 2]
            for name, arr in (("qlink1_troute", q), ("qlink2_troute", q),
                              ("hlink_troute", h)):
                if name in f:
                    del f[name]
                f.create_dataset(name, data=arr)
            written.append(path)
    return written

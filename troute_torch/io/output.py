"""Simulation output writers.

Array-first equivalents of the reference's ``nwm_output_generator``
(``nwm_routing/output.py:117``) / ``nhd_io`` writers: flowveldepth CSV and
NetCDF (stream_output), chanobs, lakeout, and lastobs files.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from troute_torch.io.netcdf import write_netcdf


def flowveldepth_dataframe(ids, fvd, t0, dt):
    """fvd [nts, N, 3] -> wide DataFrame indexed by feature id with
    (timestamp, variable) columns — the reference's flowveldepth layout."""
    nts = fvd.shape[0]
    times = pd.date_range(t0 + pd.Timedelta(seconds=dt), periods=nts,
                          freq=pd.Timedelta(seconds=dt))
    cols = pd.MultiIndex.from_product([times, ("q", "v", "d")])
    data = np.asarray(fvd).transpose(1, 0, 2).reshape(len(ids), nts * 3)
    return pd.DataFrame(data, index=np.asarray(ids), columns=cols)


def write_flowveldepth_csv(path, ids, fvd, t0, dt):
    try:
        # pyarrow from raw numpy column slices: no pandas DataFrame is
        # materialized (the MultiIndex frame alone costs seconds at CONUS
        # width) and write_csv is ~20x faster than pandas.to_csv
        import pyarrow as pa
        import pyarrow.csv as pacsv
        fvd = np.asarray(fvd)
        nts = fvd.shape[0]
        times = pd.date_range(t0 + pd.Timedelta(seconds=dt), periods=nts,
                              freq=pd.Timedelta(seconds=dt))
        names = ["featureID"]
        arrays = [pa.array(np.asarray(ids, np.int64))]
        body = np.ascontiguousarray(fvd.transpose(0, 2, 1))  # [nts, 3, N]
        for k, ts in enumerate(times):
            iso = ts.isoformat()
            for j, v in enumerate(("q", "v", "d")):
                names.append(f"{iso}_{v}")
                arrays.append(pa.array(body[k, j]))
        pacsv.write_csv(pa.Table.from_arrays(arrays, names=names),
                        str(path))
    except ImportError:
        df = flowveldepth_dataframe(ids, fvd, t0, dt)
        df.to_csv(path)
    return path


def write_stream_output_nc(path, ids, fvd, t0, dt):
    """Write q/v/d series as a netCDF4 file (stream_output equivalent)."""
    fvd = np.asarray(fvd)
    nts = fvd.shape[0]
    times = (np.arange(1, nts + 1) * dt).astype(np.int64)
    write_netcdf(
        path,
        variables={
            "feature_id": np.asarray(ids, np.int64),
            "time": times,
            "flow": fvd[:, :, 0].T.astype(np.float32),
            "velocity": fvd[:, :, 1].T.astype(np.float32),
            "depth": fvd[:, :, 2].T.astype(np.float32),
        },
        dims={
            "flow": ("feature_id", "time"),
            "velocity": ("feature_id", "time"),
            "depth": ("feature_id", "time"),
        },
        attrs={
            "time": {"units": "seconds since %s"
                     % t0.strftime("%Y-%m-%d %H:%M:%S")},
            "flow": {"units": "m3 s-1"},
            "velocity": {"units": "m s-1"},
            "depth": {"units": "m"},
        },
        global_attrs={"TITLE": "troute_torch stream output",
                      "model_initialization_time":
                          t0.strftime("%Y-%m-%d_%H:%M:%S")})
    return path


_EPOCH = np.datetime64("1970-01-01T00:00:00")


def write_chanobs_nc(path, gage_ids, gage_feature_ids, fvd_at_gages, t0,
                     dt, append: bool = True):
    """Modeled flow at gage locations (chanobs equivalent).

    Matches the reference layout (``nhd_io.write_chanobs``,
    ``nhd_io.py:516-667``): ``streamflow`` is [time, feature_id] with an
    UNLIMITED time axis in minutes since the 1970 epoch, so consecutive
    forecast cycles writing to the same ``chanobs_filepath`` APPEND along
    time (create-if-missing, append-if-exists) exactly like the
    reference.  ``append=False`` always writes a fresh file.
    """
    import h5py

    q = np.asarray(fvd_at_gages)[:, :, 0].astype(np.float32)  # [nts, n_g]
    nts = q.shape[0]
    t0_min = (np.datetime64(t0) - _EPOCH) / np.timedelta64(1, "m")
    times = (t0_min + np.arange(1, nts + 1) * (dt / 60.0)).astype(np.int32)

    import os
    if append and os.path.exists(path):
        # append along the unlimited time axis (reference
        # nhd_io.py:645-667)
        with h5py.File(path, "r+") as f:
            tshape = f["time"].shape[0]
            f["time"].resize((tshape + nts,))
            f["time"][tshape:] = times
            f["streamflow"].resize((tshape + nts,
                                    f["streamflow"].shape[1]))
            f["streamflow"][tshape:] = q
        return path

    with h5py.File(path, "w") as f:
        fid = f.create_dataset(
            "feature_id", data=np.asarray(gage_feature_ids, np.int64))
        fid.attrs["long_name"] = "Reach ID"
        fid.make_scale("feature_id")
        tvar = f.create_dataset("time", data=times, maxshape=(None,),
                                chunks=(max(nts, 1),))
        tvar.attrs["long_name"] = "model initialization time"
        tvar.attrs["standard_name"] = "forecast_reference_time"
        tvar.attrs["units"] = "minutes since 1970-01-01 00:00:00 UTC"
        tvar.make_scale("time")
        ref = f.create_dataset(
            "reference_time", data=np.asarray([t0_min], np.int32))
        ref.attrs["long_name"] = "vaild output time"
        ref.attrs["standard_name"] = "time"
        ref.attrs["units"] = "minutes since 1970-01-01 00:00:00 UTC"
        y = f.create_dataset(
            "streamflow", data=q, maxshape=(None, q.shape[1]),
            chunks=(max(nts, 1), max(q.shape[1], 1)), fillvalue=np.nan)
        y.attrs["units"] = "m3 s-1"
        y.dims[0].attach_scale(tvar)
        y.dims[1].attach_scale(fid)
        f.attrs["TITLE"] = "troute_torch chanobs"
        f.attrs["model_initialization_time"] = \
            t0.strftime("%Y-%m-%d_%H:%M:%S")
    return path


def write_lakeout_nc(path, lake_ids, outflow, water_elevation, inflow, t0):
    """Waterbody states at one output time (lakeout equivalent)."""
    write_netcdf(
        path,
        variables={
            "lake_id": np.asarray(lake_ids, np.int64),
            "outflow": np.asarray(outflow, np.float64),
            "water_sfc_elev": np.asarray(water_elevation, np.float32),
            "inflow": np.asarray(inflow, np.float64),
        },
        dims={"outflow": ("lake_id",), "water_sfc_elev": ("lake_id",),
              "inflow": ("lake_id",)},
        global_attrs={"TITLE": "troute_torch lakeout",
                      "valid_time": t0.strftime("%Y-%m-%d_%H:%M:%S")})
    return path


def write_lastobs_nc(path, gage_ids, lastobs_time, lastobs_discharge, t0):
    """Persisted last-observation state for DA warm restart.

    Writes the reference nudgingLastObs schema (``lastobs_df_output``,
    nhd_io.py:1737-1773): char ``stationId`` ('|S15', stationIdInd), char
    ``time`` ('|S19' timestamps, stationIdInd x timeInd) and ``discharge``
    (stationIdInd x timeInd), with global ``modelTimeAtOutput``.

    ``lastobs_time`` is the observation time in seconds relative to ``t0``
    (the model time at output; non-positive, NaN = never observed — the
    reference fills NaN offsets with 0 so the timestamp equals ``t0``).
    """
    from datetime import timedelta

    gid = np.asarray([str(g).ljust(15)[:15] for g in gage_ids], dtype="S15")
    off = np.nan_to_num(np.asarray(lastobs_time, np.float64), nan=0.0)
    stamps = [(t0 + timedelta(seconds=float(s)))
              .strftime("%Y-%m-%d_%H:%M:%S") for s in off]
    times = np.asarray(stamps, dtype="S19").reshape(-1, 1)
    disch = np.asarray(lastobs_discharge, np.float64).reshape(-1, 1)
    write_netcdf(
        path,
        variables={
            "stationId": gid,
            "time": times,
            "discharge": disch,
        },
        dims={"stationId": ("stationIdInd",),
              "time": ("stationIdInd", "timeInd"),
              "discharge": ("stationIdInd", "timeInd")},
        global_attrs={"modelTimeAtOutput":
                      t0.strftime("%Y-%m-%d_%H:%M:%S")})
    return path


def apply_stream_mask(ids, fvd, nudge_rows, mask_list, nexus_members=None):
    """Subset/aggregate outputs per the mask YAML (reference
    ``mask_find_seg``/``updated_flowveldepth``, nhd_io.py:2245-2347).

    ``mask_list``: {"wb": [...ids or 9999], "nex": [...ids or 9999]}.
    Nexus rows aggregate member flowpaths: flow summed, velocity NaN when
    more than one member, depth averaged.

    Returns (ids_out, types_out, fvd_out [nts, M, 3], nudge_out or None).
    """
    ids = np.asarray(ids, np.int64)
    fvd = np.asarray(fvd)
    pos = {int(s): k for k, s in enumerate(ids)}

    out_ids, out_types, cols = [], [], []
    wb = mask_list.get("wb") or []
    if wb:
        keep = ids if 9999 in wb else [s for s in wb if s in pos]
        for s in keep:
            out_ids.append(int(s))
            out_types.append("wb")
            cols.append(fvd[:, pos[int(s)], :])

    nex = mask_list.get("nex") or []
    if nex and nexus_members:
        nex_keys = (list(nexus_members) if 9999 in nex
                    else [n for n in nex if n in nexus_members])
        for nx in nex_keys:
            members = [pos[m] for m in nexus_members[nx] if m in pos]
            if not members:
                continue
            block = fvd[:, members, :]
            q = block[:, :, 0].sum(axis=1)
            v = (block[:, 0, 1] if len(members) == 1
                 else np.full(fvd.shape[0], np.nan))
            d = block[:, :, 2].mean(axis=1)
            out_ids.append(int(nx))
            out_types.append("nex")
            cols.append(np.stack([q, v, d], axis=-1))

    if not cols:
        return (np.zeros(0, np.int64), [],
                np.zeros((fvd.shape[0], 0, 3)), None)
    fvd_out = np.stack(cols, axis=1)
    return np.asarray(out_ids, np.int64), out_types, fvd_out, None


def write_stream_output(out_dir, ids, fvd, t0, dt, nudge=None,
                        nudge_ids=None,
                        output_type=".nc", file_hours=1.0,
                        internal_frequency_min=None,
                        mask_list=None, nexus_members=None):
    """Full-featured stream output (reference ``nhd_io.write_flowveldepth``):
    one file per ``file_hours`` of simulation, rows subsampled at
    ``internal_frequency_min`` minutes, as netCDF / CSV / pickle, with
    optional wb/nex masking.

    Returns list of written paths.
    """
    import pandas as pd

    from pathlib import Path

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fvd = np.asarray(fvd)
    nts = fvd.shape[0]
    types = ["wb"] * len(ids)
    if mask_list:
        ids, types, fvd, _ = apply_stream_mask(ids, fvd, None, mask_list,
                                               nexus_members)

    steps = np.arange(1, nts + 1)
    if internal_frequency_min:
        keep = (steps * dt) % (internal_frequency_min * 60.0) == 0
        if not keep.any():
            keep = np.ones(nts, bool)
    else:
        keep = np.ones(nts, bool)

    per_file = max(int(round(file_hours * 3600.0 / dt)), 1)
    written = []
    for start in range(0, nts, per_file):
        sel = np.zeros(nts, bool)
        sel[start:start + per_file] = True
        sel &= keep
        if not sel.any():
            continue
        sub = fvd[sel]
        t_secs = (steps[sel] * dt).astype(np.int64)
        stamp = (t0 + pd.Timedelta(seconds=float(start * dt))) \
            .strftime("%Y%m%d%H%M")
        path = out_dir / f"troute_output_{stamp}{output_type}"
        if output_type == ".nc":
            nsub = nudge[sel] if nudge is not None else None
            _write_stream_nc(path, ids, types, sub, t_secs, t0,
                             nudge=nsub, nudge_ids=nudge_ids)
        else:
            cols = {}
            times = [t0 + pd.Timedelta(seconds=int(s)) for s in t_secs]
            for k, ts in enumerate(times):
                cols[f"{ts.isoformat()}_q"] = sub[k, :, 0]
                cols[f"{ts.isoformat()}_v"] = sub[k, :, 1]
                cols[f"{ts.isoformat()}_d"] = sub[k, :, 2]
            df = pd.DataFrame(cols, index=pd.Index(ids, name="featureID"))
            df["Type"] = types
            if output_type == ".csv":
                df.to_csv(path)
            else:
                df.to_pickle(path)
        written.append(path)
    return written


def _write_stream_nc(path, ids, types, sub, t_secs, t0, nudge=None,
                     nudge_ids=None):
    variables = {
        "feature_id": np.asarray(ids, np.int64),
        "type": np.asarray([t.encode() for t in types], dtype="S3"),
        "time": t_secs,
        "flow": sub[:, :, 0].T.astype(np.float32),
        "velocity": sub[:, :, 1].T.astype(np.float32),
        "depth": sub[:, :, 2].T.astype(np.float32),
    }
    dims = {
        "type": ("feature_id",),
        "flow": ("feature_id", "time"),
        "velocity": ("feature_id", "time"),
        "depth": ("feature_id", "time"),
    }
    if nudge is not None and nudge.size:
        variables["nudge"] = np.asarray(nudge).T.astype(np.float32)
        variables["nudge_feature_id"] = np.asarray(nudge_ids, np.int64)
        dims["nudge"] = ("nudge_feature_id", "time")
    write_netcdf(
        path,
        variables=variables,
        dims=dims,
        attrs={
            "time": {"units": "seconds since %s"
                     % t0.strftime("%Y-%m-%d %H:%M:%S")},
            "flow": {"units": "m3 s-1"},
            "velocity": {"units": "m s-1"},
            "depth": {"units": "m"},
        },
        global_attrs={"TITLE": "troute_torch stream output",
                      "model_initialization_time":
                          t0.strftime("%Y-%m-%d_%H:%M:%S")})


def append_chrtout(chrtout_files, ids, fvd, qts_subdivisions):
    """Append ``streamflow_troute`` into existing CHRTOUT files (reference
    ``nhd_io.write_chrtout``, nhd_io.py:737-800): file k holds the flow at
    simulation step (k+1)*qts_subdivisions - 1, ordered by the file's own
    feature_id variable.

    Returns the list of files written.
    """
    import h5py

    fvd = np.asarray(fvd)
    nts = fvd.shape[0]
    n_files = nts // qts_subdivisions
    row_of = {int(s): k for k, s in enumerate(ids)}
    written = []
    for k, path in enumerate(list(chrtout_files)[:n_files]):
        step = (k + 1) * qts_subdivisions - 1
        with h5py.File(path, "a") as f:
            fids = f["feature_id"][...].astype(np.int64)
            q = np.zeros(fids.size, np.float32)
            for i, s in enumerate(fids):
                r = row_of.get(int(s))
                if r is not None:
                    q[i] = fvd[step, r, 0]
            if "streamflow_troute" in f:
                del f["streamflow_troute"]
            d = f.create_dataset("streamflow_troute", data=q)
            d.attrs["long_name"] = np.bytes_("River Flow")
            d.attrs["units"] = np.bytes_("m3 s-1")
        written.append(path)
    return written

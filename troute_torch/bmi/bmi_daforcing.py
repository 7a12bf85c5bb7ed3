"""Standalone DA-forcing BMI.

Port of ``troute_torch/bmi/bmi_daforcing.py`` on the port's readers and
writers (``io/timeslice.py``, ``io/rfc.py``, ``io/restart.py``,
``io/output.py``); host NumPy and pandas only, so it takes no device.

Pre-reads data-assimilation inputs (USGS/USACE TimeSlice observations,
RFC forecast series, lastobs warm-start, lite restart) and exposes them as
flat BMI transport arrays for the routing BMI; on the way back it persists
routing state (lite restart, lastobs).  Mirrors the reference's
``bmi_DAforcing.py`` + ``model_DAforcing.py`` surface (variable names
match so NextGen couplers can swap implementations).
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np
import pandas as pd

from troute_torch.bmi import codec

_OUTPUT_VARS = (
    "usgs_Array", "datesSecondsArray_usgs", "nDates_usgs",
    "stationArray_usgs", "stationStringLengthArray_usgs", "nStations_usgs",
    "usgs_reservoir_Array", "datesSecondsArray_reservoir_usgs",
    "nDates_reservoir_usgs", "stationArray_reservoir_usgs",
    "stationStringLengthArray_reservoir_usgs", "nStations_reservoir_usgs",
    "usace_reservoir_Array", "datesSecondsArray_reservoir_usace",
    "nDates_reservoir_usace", "stationArray_reservoir_usace",
    "stationStringLengthArray_reservoir_usace", "nStations_reservoir_usace",
    "rfc_da_timestep", "rfc_totalCounts", "rfc_synthetic_values",
    "rfc_discharges", "rfc_timeseries_idx", "rfc_use_rfc",
    "rfc_timeSteps", "rfc_StationId_array", "rfc_StationId_stringLengths",
    "lastObs_gageArray", "lastObs_gageStringLengths", "lastObs_timeSince",
    "lastObs_discharge",
    "q0_Array", "q0_indexArray", "q0_nIndex",
    "waterbodyLR_Array", "waterbodyLR_indexArray", "waterbodyLR_nIndex",
    "t0", "dateNull",
)
_INPUT_VARS = (
    "write_lite_restart", "q0", "q0_ids", "waterbody_df",
    "waterbody_df_ids", "lastobs_discharge", "lastobs_times",
    "lastobs_gage_ids",
)


class DAforcingModel:
    """Config-driven DA input staging (reference ``DAforcing_model``)."""

    def __init__(self, config_file):
        from troute_torch.config import load_config
        from troute_torch.io.timeslice import get_obs_from_timeslices

        cfg = load_config(config_file)
        self.cfg = cfg
        base = Path(config_file).parent
        self.base = base
        cp = cfg.compute_parameters
        dap = cp.data_assimilation_parameters
        rp = cp.restart_parameters
        fp = cp.forcing_parameters
        self.dap = dap
        self.t0 = pd.to_datetime(
            str(rp.start_datetime).replace("_", " ")) \
            if rp.start_datetime else pd.Timestamp("2000-01-01")
        dt, nts = float(fp.dt), int(fp.nts or 0)

        sda = dap.streamflow_da
        nudging = bool(sda and sda.streamflow_nudging)
        rda = dap.reservoir_da
        pda = rda.reservoir_persistence_da if rda else None
        use_usgs = bool(pda and pda.reservoir_persistence_usgs)
        use_usace = bool(pda and pda.reservoir_persistence_usace)
        rfc = rda.reservoir_rfc_da if rda else None
        use_rfc = bool(rfc and rfc.reservoir_rfc_forecasts)

        lookback = pd.Timedelta(hours=dap.timeslice_lookback_hours or 24)

        def window_files(folder, pattern):
            if not folder:
                return []
            files = sorted((base / folder).glob(pattern))
            return [f for f in files
                    if self.t0 - lookback
                    <= pd.to_datetime(f.name.split(".")[0],
                                      format="%Y-%m-%d_%H:%M:%S")
                    <= self.t0 + pd.Timedelta(seconds=nts * dt)]

        def all_stations(files):
            from troute_torch.io.timeslice import read_timeslice_file
            st = set()
            for f in files:
                try:
                    st.update(read_timeslice_file(f)["stationId"])
                except (OSError, KeyError):
                    continue
            return sorted(st)

        self.usgs_df = pd.DataFrame()
        self.reservoir_usgs_df = pd.DataFrame()
        self.reservoir_usace_df = pd.DataFrame()
        if nudging or use_usgs:
            files = window_files(dap.usgs_timeslices_folder,
                                 "*.usgsTimeSlice.ncdf")
            gages = all_stations(files)
            if gages:
                df = get_obs_from_timeslices(
                    np.asarray(gages), files,
                    qc_threshold=dap.qc_threshold or 1.0,
                    interpolation_limit=dap.interpolation_limit_min or 59,
                    frequency_secs=float(dt), t0=None, nts=None)
                if nudging:
                    self.usgs_df = df
                if use_usgs and not df.empty:
                    # reservoir DA searches raw 15-min observations
                    dfr = df.T
                    self.reservoir_usgs_df = \
                        dfr.resample("15min").asfreq().T
        if use_usace:
            files = window_files(dap.usace_timeslices_folder,
                                 "*.usaceTimeSlice.ncdf")
            gages = all_stations(files)
            if gages:
                self.reservoir_usace_df = get_obs_from_timeslices(
                    np.asarray(gages), files,
                    qc_threshold=dap.qc_threshold or 1.0,
                    interpolation_limit=dap.interpolation_limit_min or 59,
                    frequency_secs=900.0, t0=None, nts=None)

        # RFC forecast series: one row per gage found in the folder
        self.rfc = []
        if use_rfc and rfc.reservoir_rfc_forecasts_time_series_path:
            from troute_torch.io.rfc import preprocess_rfc_data
            folder = base / rfc.reservoir_rfc_forecasts_time_series_path
            gages = sorted({Path(f).name.split(".")[2]
                            for f in glob.glob(
                                str(folder / "*.RFCTimeSeries.ncdf"))})
            for g in gages:
                r = preprocess_rfc_data(
                    self.t0, rfc.reservoir_rfc_forecasts_offset_hours, g,
                    folder, dt)
                if r is not None:
                    r["gage"] = g
                    self.rfc.append(r)

        # lastobs warm start
        self.lastobs = None
        if sda and sda.lastobs_file:
            from troute_torch.io.restart import read_lastobs_file
            self.lastobs = read_lastobs_file(base / sda.lastobs_file)

        # lite restart
        self.q0_df = pd.DataFrame()
        self.waterbody_df = pd.DataFrame()
        lrf = getattr(rp, "lite_channel_restart_file", None)
        lwf = getattr(rp, "lite_waterbody_restart_file", None)
        from troute_torch.io.restart import read_lite_restart
        if lrf and (base / lrf).exists():
            self.q0_df = read_lite_restart(base / lrf)
        if lwf and (base / lwf).exists():
            self.waterbody_df = read_lite_restart(base / lwf)


class BmiDAforcing:
    """BMI 2.0 surface (reference ``bmi_DAforcing.py``)."""

    def __init__(self):
        self._model = None
        self._values: dict = {}
        self._time = 0.0

    # ---- control ----
    def initialize(self, config_file: str = "") -> None:
        m = DAforcingModel(config_file)
        self._model = m
        v = self._values
        t0 = m.t0
        v["t0"] = np.asarray([t0.value // 10**9], np.int64)
        v["dateNull"] = np.asarray([t0.value // 10**9], np.int64)
        v["write_lite_restart"] = np.zeros(1)

        def stage(prefix, df):
            if df.empty:
                v[f"{prefix}_Array"] = np.zeros(0)
                v[f"nDates_{prefix}"] = np.zeros(1, np.int64)
                v[f"nStations_{prefix}"] = np.zeros(1, np.int64)
                v[f"datesSecondsArray_{prefix}"] = np.zeros(0, np.int64)
                v[f"stationArray_{prefix}"] = np.zeros(0, np.uint8)
                v[f"stationStringLengthArray_{prefix}"] = np.zeros(0,
                                                                   np.int32)
                return
            secs, nd, codes, lens, ns = codec.time_stations_from_df(df, t0)
            v[f"datesSecondsArray_{prefix}"] = secs
            v[f"nDates_{prefix}"] = np.asarray([nd], np.int64)
            v[f"stationArray_{prefix}"] = codes
            v[f"stationStringLengthArray_{prefix}"] = lens
            v[f"nStations_{prefix}"] = np.asarray([ns], np.int64)
            v[f"{prefix}_Array"] = codec.flatten_array(df)

        stage("usgs", m.usgs_df)
        stage("reservoir_usgs", m.reservoir_usgs_df)
        stage("reservoir_usace", m.reservoir_usace_df)
        # match reference variable aliases
        v["usgs_reservoir_Array"] = v.pop("reservoir_usgs_Array",
                                          np.zeros(0))
        v["usace_reservoir_Array"] = v.pop("reservoir_usace_Array",
                                           np.zeros(0))

        # RFC rows, ragged series padded to the longest
        rows = m.rfc
        if rows:
            n_max = max(r["series"].size for r in rows)
            disc = np.zeros((len(rows), n_max))
            for i, r in enumerate(rows):
                disc[i, :r["series"].size] = r["series"]
            v["rfc_discharges"] = disc.flatten()
            v["rfc_da_timestep"] = np.asarray(
                [r["time_step_seconds"] for r in rows], np.int64)
            v["rfc_totalCounts"] = np.asarray(
                [r["total_counts"] for r in rows], np.int64)
            v["rfc_timeseries_idx"] = np.asarray(
                [r["timeseries_idx"] for r in rows], np.int64)
            v["rfc_use_rfc"] = np.asarray(
                [r["use_rfc"] for r in rows], np.int64)
            v["rfc_timeSteps"] = np.asarray(
                [r["series"].size for r in rows], np.int64)
            v["rfc_synthetic_values"] = np.zeros(len(rows))
            codes, lens = codec.encode_strings([r["gage"] for r in rows])
            v["rfc_StationId_array"] = codes
            v["rfc_StationId_stringLengths"] = lens
        else:
            for k in ("rfc_discharges", "rfc_da_timestep",
                      "rfc_totalCounts", "rfc_timeseries_idx",
                      "rfc_use_rfc", "rfc_timeSteps",
                      "rfc_synthetic_values", "rfc_StationId_array",
                      "rfc_StationId_stringLengths"):
                v[k] = np.zeros(0)

        if m.lastobs is not None:
            gages, disc, times = m.lastobs
            codes, lens, tt, dd = codec.disassemble_lastobs(
                gages, times, disc)
            v["lastObs_gageArray"] = codes
            v["lastObs_gageStringLengths"] = lens
            v["lastObs_timeSince"] = tt
            v["lastObs_discharge"] = dd
        else:
            for k in ("lastObs_gageArray", "lastObs_gageStringLengths",
                      "lastObs_timeSince", "lastObs_discharge"):
                v[k] = np.zeros(0)

        for name, df in (("q0", m.q0_df), ("waterbodyLR", m.waterbody_df)):
            if df.empty:
                v[f"{name}_Array"] = np.zeros(0)
                v[f"{name}_indexArray"] = np.zeros(0, np.int64)
                v[f"{name}_nIndex"] = np.zeros(1, np.int64)
            else:
                v[f"{name}_Array"] = df.to_numpy(np.float64).flatten()
                v[f"{name}_indexArray"] = df.index.to_numpy(np.int64)
                v[f"{name}_nIndex"] = np.asarray([len(df)], np.int64)

        # inputs from the routing BMI
        for k in _INPUT_VARS:
            v.setdefault(k, np.zeros(0))

    def update(self) -> None:
        """Persist routing state handed back by the routing BMI."""
        v = self._values
        m = self._model
        if int(np.asarray(v.get("write_lite_restart", [0])).ravel()[0]):
            op = m.cfg.output_parameters
            folder = None
            if op.lite_restart:
                folder = op.lite_restart.get("lite_restart_output_directory")
            if folder and v["q0"].size:
                from troute_torch.io.restart import write_lite_restart
                q0 = np.asarray(v["q0"], np.float64).reshape(-1, 3)
                q0_df = pd.DataFrame(
                    q0, index=np.asarray(v["q0_ids"], np.int64),
                    columns=["qu0", "qd0", "h0"])
                wb = pd.DataFrame()
                if v["waterbody_df"].size:
                    wb = pd.DataFrame(
                        np.asarray(v["waterbody_df"],
                                   np.float64).reshape(
                            len(v["waterbody_df_ids"]), -1),
                        index=np.asarray(v["waterbody_df_ids"], np.int64))
                write_lite_restart(Path(m.base) / folder, m.t0, q0_df, wb)
            sda = m.dap.streamflow_da
            out_dir = sda.lastobs_output_folder if sda else None
            if out_dir and v["lastobs_gage_ids"].size:
                from troute_torch.io.output import write_lastobs_nc
                gages = codec.decode_strings(
                    v["lastobs_gage_ids"],
                    np.full(len(v["lastobs_discharge"]), 15))
                write_lastobs_nc(
                    Path(m.base) / out_dir /
                    f"nudgingLastObs.{m.t0.strftime('%Y-%m-%d_%H:%M:%S')}"
                    ".nc",
                    gages, v["lastobs_times"], v["lastobs_discharge"],
                    m.t0)
            v["write_lite_restart"] = np.zeros(1)
        self._time += 1.0

    def update_until(self, until: float) -> None:
        self.update()
        self._time = until

    def finalize(self) -> None:
        self._model = None

    # ---- variable access ----
    def get_value(self, name, dest=None):
        val = np.asarray(self._values[name])
        if dest is not None:
            dest[...] = val
            return dest
        return val

    def get_value_ptr(self, name):
        return self._values[name]

    def set_value(self, name, src):
        self._values[name] = np.asarray(src)

    def get_value_at_indices(self, name, dest, inds):
        dest[...] = np.asarray(self._values[name])[inds]
        return dest

    def set_value_at_indices(self, name, inds, src):
        arr = np.asarray(self._values[name])
        arr[inds] = src
        self._values[name] = arr

    # ---- introspection ----
    def get_component_name(self):
        return "DAforcing for t-route (PyTorch)"

    def get_input_item_count(self):
        return len(_INPUT_VARS)

    def get_output_item_count(self):
        return len(_OUTPUT_VARS)

    def get_input_var_names(self):
        return _INPUT_VARS

    def get_output_var_names(self):
        return _OUTPUT_VARS

    def get_var_type(self, name):
        return str(np.asarray(self._values[name]).dtype)

    def get_var_units(self, name):
        return "m3 s-1" if "discharge" in name.lower() else "none"

    def get_var_itemsize(self, name):
        return np.asarray(self._values[name]).itemsize

    def get_var_nbytes(self, name):
        return np.asarray(self._values[name]).nbytes

    def get_var_location(self, name):
        return "node"

    def get_var_grid(self, name):
        return 0

    def get_grid_rank(self, grid):
        return 1

    def get_grid_size(self, grid):
        return 1

    def get_grid_type(self, grid):
        return "scalar"

    def get_current_time(self):
        return self._time

    def get_start_time(self):
        return 0.0

    def get_end_time(self):
        return np.finfo("d").max

    def get_time_step(self):
        return 1.0

    def get_time_units(self):
        return "s"

"""Standalone single-reservoir BMI.

Port of ``troute_tpu/bmi/bmi_reservoirs.py`` on the port's
``ops/levelpool.py`` (through ``ops/levelpool_cuda.py``: kernel L1 on a
card) and ``ops/reservoir_da.py``, in float64 on the
constructor's device (the first CUDA device unless ``device="cpu"`` is
given; with neither the constructor raises).  Equivalent of the
reference's auxiliary reservoir BMI (``src/bmi_reservoirs.py`` +
``src/model_reservoir.py``): a coupler drives ONE levelpool reservoir —
optionally with hybrid-persistence or RFC DA — by pushing inflows and
pulling outflow/elevation each timestep.  Same input variable names as
the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from troute_torch.bmi.bmi_troute import resolve_device

_INPUT_VARS = (
    "lake_surface__elevation", "LkArea", "WeirE", "WeirC", "WeirL",
    "dam_length", "OrificeE", "OrificeC", "OrificeA", "LkMxE",
    "waterbody_id", "ifd", "upstream_ids", "res_type", "da_idx",
    "time_step", "rfc_forecast_persist_seconds", "synthetic_flag",
    "lake_water~incoming__volume_flow_rate",
    "gage_observations", "gage_time", "rfc_timeseries_discharges",
    "rfc_timeseries_idx", "rfc_total_counts", "rfc_timeseries_update_time",
    "rfc_da_timestep",
)
_OUTPUT_VARS = ("lake_water~outgoing__volume_flow_rate",
                "lake_surface__elevation")


class BmiReservoir:
    """BMI for one reservoir (levelpool + optional per-type DA)."""

    def __init__(self, device=None):
        self._device = resolve_device(device)
        self._values: dict[str, np.ndarray] = {}
        self._time = 0.0
        self._dt = 300.0
        self._initialized = False
        self._state_ready = False

    # ------------------------------------------------------------ control
    def initialize(self, config_file: str = "") -> None:
        for name in _INPUT_VARS + _OUTPUT_VARS:
            self._values.setdefault(name, np.zeros(0))
        self._initialized = True

    def _t(self, values, dtype=torch.float64):
        return torch.as_tensor(np.asarray(values), dtype=dtype,
                               device=self._device)

    def _setup(self):
        from troute_torch.ops.levelpool import LevelpoolParams
        from troute_torch.ops.reservoir_da import HybridDAState, RfcDAState

        v = self._values
        t = self._t

        def sc(name, default=0.0):
            arr = np.asarray(v.get(name, np.zeros(0)), np.float64).ravel()
            return float(arr[0]) if arr.size else default

        self._params = LevelpoolParams(
            area=t([sc("LkArea")]), max_depth=t([sc("LkMxE")]),
            orifice_area=t([sc("OrificeA")]),
            orifice_coeff=t([sc("OrificeC")]),
            orifice_elev=t([sc("OrificeE")]), weir_coeff=t([sc("WeirC")]),
            weir_elev=t([sc("WeirE")]), weir_length=t([sc("WeirL")]),
            dam_length=t([sc("dam_length", 10.0)]))
        elev0 = sc("lake_surface__elevation")
        if elev0 <= -1e8 or elev0 == 0.0:
            # cold start rule (reference levelpool_structs.c:97-106)
            elev0 = sc("OrificeE") + (sc("LkMxE") - sc("OrificeE")) \
                * sc("ifd", 0.9)
        self._elev = np.float64(elev0)
        self._res_type = int(sc("res_type", 1.0))
        if sc("time_step"):
            self._dt = sc("time_step")
        self._hybrid = HybridDAState(
            persisted_outflow=np.nan, update_time=0.0,
            persistence_index=0.0, persistence_update_time=0.0)
        self._rfc = RfcDAState(
            timeseries_idx=int(sc("rfc_timeseries_idx")),
            update_time=sc("rfc_timeseries_update_time"))
        self._state_ready = True

    def update(self) -> None:
        self.update_until(self._time + self._dt)

    def update_until(self, until: float) -> None:
        from troute_torch.ops.levelpool_cuda import levelpool_step_cuda
        from troute_torch.ops.reservoir_da import (
            HybridDAState, RfcDAState, hybrid_persistence_da,
            rfc_forecast_da)

        t = self._t
        i32 = torch.int32
        if not self._state_ready:
            self._setup()
        v = self._values
        n_steps = max(int(round((until - self._time) / self._dt)), 1)
        inflow_arr = np.asarray(
            v.get("lake_water~incoming__volume_flow_rate", np.zeros(0)),
            np.float64).ravel()

        outflow = 0.0
        for k in range(n_steps):
            self._time += self._dt
            inflow = float(inflow_arr[min(k, inflow_arr.size - 1)]) \
                if inflow_arr.size else 0.0
            qi = t([inflow])
            lp_out, lp_elev = levelpool_step_cuda(
                t([self._elev]), qi, qi, t([0.0]), self._dt, self._params)

            if self._res_type in (2, 3):
                obs = np.asarray(v.get("gage_observations", np.zeros(0)),
                                 np.float64).ravel()
                times = np.asarray(v.get("gage_time", np.zeros(0)),
                                   np.float64).ravel()
                if obs.size:
                    st = HybridDAState(*[t([x]) for x in self._hybrid])
                    out, elev, st2 = hybrid_persistence_da(
                        st, t([obs]), t(times), self._time, lp_out, qi,
                        self._dt, self._params.area, self._params.max_depth,
                        self._params.orifice_elev, t([self._elev]))
                    self._hybrid = HybridDAState(
                        persisted_outflow=float(st2.persisted_outflow[0]),
                        update_time=float(st2.update_time[0]),
                        persistence_index=float(st2.persistence_index[0]),
                        persistence_update_time=float(
                            st2.persistence_update_time[0]))
                    outflow, self._elev = float(out[0]), float(elev[0])
                else:
                    outflow, self._elev = float(lp_out[0]), float(lp_elev[0])
            elif self._res_type in (4, 5):
                series = np.asarray(
                    v.get("rfc_timeseries_discharges", np.zeros(0)),
                    np.float64).ravel()
                if series.size:
                    synthetic = np.asarray(
                        v.get("synthetic_flag", np.zeros(series.size)),
                        np.float64).ravel()
                    use_rfc = not bool(np.all(synthetic == 1)) \
                        and self._dt <= 3600.0
                    st = RfcDAState(
                        timeseries_idx=t([self._rfc.timeseries_idx], i32),
                        update_time=t([self._rfc.update_time]))
                    def first(name, default):
                        arr = np.asarray(v.get(name, np.zeros(0))).ravel()
                        return float(arr[0]) if arr.size else default

                    total = int(first("rfc_total_counts", series.size))
                    step = first("rfc_da_timestep", 3600.0)
                    persist = first("rfc_forecast_persist_seconds",
                                    11 * 86400.0)
                    out, elev, st2 = rfc_forecast_da(
                        st, t([series]), t([total], i32),
                        t([use_rfc], torch.bool), t([step]), t([persist]),
                        t([self._res_type], i32), self._time, qi,
                        t([self._elev]), lp_out, lp_elev,
                        self._params.area * 1.0e6, self._params.max_depth,
                        self._dt)
                    self._rfc = RfcDAState(
                        timeseries_idx=int(st2.timeseries_idx[0]),
                        update_time=float(st2.update_time[0]))
                    outflow, self._elev = float(out[0]), float(elev[0])
                else:
                    outflow, self._elev = float(lp_out[0]), float(lp_elev[0])
            else:
                outflow, self._elev = float(lp_out[0]), float(lp_elev[0])

        v["lake_water~outgoing__volume_flow_rate"] = np.asarray([outflow])
        v["lake_surface__elevation"] = np.asarray([self._elev])

    def finalize(self) -> None:
        self._values.clear()
        self._initialized = False

    # ------------------------------------------------------------ info
    def get_component_name(self):
        return "troute_torch reservoir"

    def get_input_var_names(self):
        return list(_INPUT_VARS)

    def get_output_var_names(self):
        return list(_OUTPUT_VARS)

    def get_current_time(self):
        return self._time

    def get_time_step(self):
        return self._dt

    def get_time_units(self):
        return "seconds"

    def get_value(self, name, dest=None):
        val = np.asarray(self._values[name])
        if dest is None:
            return val.copy()
        dest[:val.size] = val
        return dest

    _STATIC_VARS = ("lake_surface__elevation", "LkArea", "WeirE", "WeirC",
                    "WeirL", "dam_length", "OrificeE", "OrificeC",
                    "OrificeA", "LkMxE", "waterbody_id", "ifd",
                    "res_type", "time_step")

    def set_value(self, name, values):
        self._values[name] = np.asarray(values)
        if name in self._STATIC_VARS:
            self._state_ready = False

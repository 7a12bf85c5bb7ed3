"""BMI 2.0 adapter for NextGen coupling.

Port of ``troute_tpu/bmi/bmi_troute.py``, which mirrors the reference's
BMI surface (``src/bmi_troute.py:30-606`` + ``src/troute_model.py``): the
coupler pushes flattened network/forcing/DA arrays with ``set_value``,
advances with ``update``/``update_until``, and pulls flattened
flow/velocity/depth states with ``get_value``.  The variable names are the
reference's, so NextGen realization configs map across.

The routing state stays on the device between updates (the first CUDA
device unless the constructor is given ``device="cpu"``; with neither a
device nor that request the constructor raises).  Each update runs the
engine the port's command line runs: short steps through
``route_stepped`` (kernel B1 on the card) whatever ``compute_kernel``
says, and ``assume_short_ts: False`` through ``route()``'s fixed-point
form (``strict_iterative``).  The JAX package maps ``compute_kernel:
auto`` to its XLA engine here, where its command line resolves it by size
(``troute_tpu/bmi/bmi_troute.py:393-396``); the port has one engine, so
the two cannot disagree.  Host arrays go to the device once per update
(lateral inflow, DA), and the last step's flows come back once.  The
rows of the pushed segment order are looked up once and reused by every
update until the network or the pushed ids change.

Domain-split runs: ``upstream_fvd`` accepts another instance's boundary
flows exactly like the reference's ``bmi`` parallel compute method
(``compute.py:1580``, ``troute_model.py:204-207``).
"""

from __future__ import annotations

import numpy as np
import torch

from troute_torch.tracing import span

_SEGMENT_VARS = ("segment_id", "segment_toid", "dx", "n", "ncc", "s0",
                 "bw", "tw", "twcc", "alt", "musk", "musx", "cs")
_WATERBODY_VARS = ("waterbody_id", "waterbody_toid", "LkArea", "LkMxE",
                   "OrificeA", "OrificeC", "OrificeE", "WeirC", "WeirE",
                   "WeirL", "ifd", "qd0", "h0", "reservoir_type")

_INPUT_VARS = _SEGMENT_VARS + _WATERBODY_VARS + (
    "land_surface_water_source__volume_flow_rate",
    "upstream_id", "upstream_fvd",
    # streamflow-nudging DA transport (produced by BmiDAforcing):
    # flat [station x date] obs + date/station metadata + the
    # gage -> segment crosswalk
    "usgs_gage_observation__volume_flow_rate",
    "datesSecondsArray_usgs", "stationArray_usgs",
    "stationStringLengthArray_usgs",
    "gage_segment_id", "gage_stationArray",
    "gage_stationStringLengthArray",
    "lastObs_gageArray", "lastObs_gageStringLengths",
    "lastObs_timeSince", "lastObs_discharge",
    "lastobs__volume_flow_rate",
    # coastal depth transport for the diffusive downstream boundary
    # (reference troute_model.py:171-201)
    "depthArray_coastal", "timeArray_coastal", "nTimes_coastal",
    "stationArray_coastal", "nStations_coastal", "coastal_timeRef",
)
_OUTPUT_VARS = (
    "channel_exit_water_x-section__volume_flow_rate",
    "channel_water_flow__speed",
    "channel_water__mean_depth",
    "lake_water~incoming__volume_flow_rate",
    "lake_water~outgoing__volume_flow_rate",
    "lake_surface__elevation",
)

_UNITS = {
    "channel_exit_water_x-section__volume_flow_rate": "m3 s-1",
    "channel_water_flow__speed": "m s-1",
    "channel_water__mean_depth": "m",
    "lake_water~incoming__volume_flow_rate": "m3 s-1",
    "lake_water~outgoing__volume_flow_rate": "m3 s-1",
    "lake_surface__elevation": "m",
    "land_surface_water_source__volume_flow_rate": "m3 s-1",
}


def resolve_device(device) -> torch.device:
    """``device`` as given, or the first CUDA device when it is None; with
    neither a device nor a CUDA device visible, raise (the port never
    picks the CPU by itself)."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", 0)
    raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                       "route on the CPU")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class BmiTroute:
    """Basic Model Interface wrapper around the troute_torch engine."""

    def __init__(self, device=None):
        self._device = resolve_device(device)
        self._values: dict[str, np.ndarray] = {}
        self._cfg = None
        self._time = 0.0
        self._dt = 300.0
        self._end_time = 0.0
        self._initialized = False
        self._network_ready = False
        self._hyb = None
        # (topology, pushed segment ids, their rows, found) of the last
        # lookup of the pushed order; see _pushed_rows
        self._seg_map = (None, None, None, None)
        # the engine's counters of the last update: 'strict_sweeps' (per
        # step) and 'mc_calls' (MC solves) of a fixed-point update
        self.last_update_counts: dict = {}

    # ------------------------------------------------- control functions
    def initialize(self, config_file: str = "") -> None:
        from pathlib import Path

        from troute_torch.config import load_config

        self._cfg = load_config(config_file) if config_file else None
        self._from_files = False
        if self._cfg is not None:
            fp = self._cfg.compute_parameters.forcing_parameters
            self._dt = float(fp.dt)
            self._end_time = float((fp.nts or 0) * self._dt)
            ntp = self._cfg.network_topology_parameters
            sp = ntp.supernetwork_parameters if ntp is not None else None
            if sp and sp.geo_file_path:
                self._base = Path(config_file).parent
                self._init_from_files()
        for name in _INPUT_VARS:
            self._values.setdefault(name, np.zeros(0))
        for name in _OUTPUT_VARS:
            self._values.setdefault(name, np.zeros(0))
        self._initialized = True

    def _init_from_files(self):
        """Config-driven network (reference troute_model pattern: the BMI
        reads geo/waterbody files itself, troute_model.py:14-137), with
        optional hybrid-diffusive mainstem routing."""
        from troute_torch.network.builder import build_network
        from troute_torch.ops.levelpool import LevelpoolParams
        from troute_torch.routing.engine import (
            ChannelParams, network_arrays_from_topology)

        cfg, base = self._cfg, self._base
        dev, f32 = self._device, torch.float32
        hp = cfg.compute_parameters.hybrid_parameters
        self._hyb = None
        exclude = None
        if hp and hp.run_hybrid_routing and hp.diffusive_domain:
            from troute_torch.routing.hybrid import HybridDomain
            self._diff_dtype_str, self._diff_nel = hp.resolved_diffusive(
                dev.type)
            self._hyb = HybridDomain(cfg, base)
            exclude = self._hyb.mainstem_set
            if hp.run_refactored_network and hp.refactored_domain \
                    and hp.refactored_topobathy_domain:
                self._hyb.load_refactored(
                    base / hp.refactored_domain,
                    base / hp.refactored_topobathy_domain)
            elif hp.use_natl_xsections and hp.topobathy_domain:
                self._hyb.load_topobathy(base / hp.topobathy_domain)

        built = build_network(cfg, base, exclude_ids=exclude)
        self._built = built
        topo = built.topo
        self._topo = topo
        self._chan = ChannelParams.from_arrays(device=dev, dtype=f32,
                                               **built.chan)
        self._lp = LevelpoolParams.from_array(built.res_params, device=dev,
                                              dtype=f32)
        self._net = network_arrays_from_topology(topo, device=dev)
        self._q = torch.as_tensor(built.q0, dtype=f32, device=dev)
        self._d = torch.as_tensor(built.depth0, dtype=f32, device=dev)
        self._elev = torch.as_tensor(built.res_elev0, dtype=f32, device=dev)
        self._dst = None          # carried diffusive state
        self._coastal = None      # (db series [R, n_db], dt_db, t_ref)
        self._from_files = True
        self._network_ready = True

        ms_ids = (np.asarray(sorted(self._hyb.mainstem_set), np.int64)
                  if self._hyb else np.zeros(0, np.int64))
        self._ms_ids = ms_ids
        self._values["segment_id"] = np.concatenate(
            [np.asarray(topo.ids), ms_ids])

    def _ingest_coastal_transport(self):
        """Coastal depth series from BMI transport arrays (reference
        troute_model.py:171-201): stations are tailwater ids, times are
        seconds since ``coastal_timeRef``."""
        v = self._values
        flat = np.asarray(v.get("depthArray_coastal", np.zeros(0)),
                          np.float64)
        if not (flat.size and self._hyb):
            return
        n_st = int(np.asarray(v["nStations_coastal"]).ravel()[0])
        times = np.asarray(v["timeArray_coastal"], np.float64)
        stations = np.asarray(v["stationArray_coastal"], np.int64)
        series = flat.reshape(n_st, -1)
        dt_db = float(times[1] - times[0]) if times.size > 1 else 3600.0
        tw_reach = self._hyb.tailwater_reaches()
        db = np.full((self._hyb.n_reaches, series.shape[1]), np.nan)
        found = False
        for k, tw in enumerate(stations):
            ri = tw_reach.get(int(tw))
            if ri is not None:
                db[ri] = series[k]
                found = True
        if found:
            self._coastal = (db, dt_db, float(times[0]))
        v["depthArray_coastal"] = np.zeros(0)   # consumed

    def _rows_of(self, ids) -> tuple:
        """Topology rows of ``ids`` and whether each is a node (the JAX
        package's ``topo.index_of`` lookups, as arrays)."""
        from troute_torch.network.builder import positions_of
        return positions_of(np.asarray(self._topo.ids, np.int64), ids)

    def _pushed_rows(self) -> tuple:
        """``_rows_of`` the pushed ``segment_id`` order, looked up again
        only when the network was rebuilt or the pushed ids differ from
        those of the last lookup (a ``set_value_at_indices`` or a write
        through ``get_value_ptr`` changes them without a rebuild)."""
        seg_ids = np.asarray(self._values["segment_id"], np.int64)
        topo, ids, rows, found = self._seg_map
        if topo is not self._topo or not np.array_equal(ids, seg_ids):
            rows, found = self._rows_of(seg_ids)
            self._seg_map = (self._topo, seg_ids.copy(), rows, found)
        return rows, found

    def _build_network(self):
        """The network pushed through ``set_value`` (segment and waterbody
        arrays), in the pushed row order."""
        from troute_torch.network.topology import (NODE_RESERVOIR,
                                                   build_topology)
        from troute_torch.ops.levelpool import LevelpoolParams
        from troute_torch.routing.engine import (
            ChannelParams, network_arrays_from_topology)

        v = self._values
        dev, f32 = self._device, torch.float32
        seg_ids = np.asarray(v["segment_id"], np.int64)
        seg_to = np.asarray(v["segment_toid"], np.int64)
        wb_ids = np.asarray(v.get("waterbody_id", np.zeros(0)), np.int64)

        node_ids = seg_ids
        down = seg_to
        node_type = np.zeros(node_ids.size, np.int8)
        if wb_ids.size:
            wb_to = np.asarray(v["waterbody_toid"], np.int64)
            node_ids = np.concatenate([node_ids, wb_ids])
            down = np.concatenate([down, wb_to])
            node_type = np.concatenate(
                [node_type, np.full(wb_ids.size, NODE_RESERVOIR, np.int8)])

        topo = build_topology(
            node_ids, down, node_type,
            terminal_codes=tuple(
                set(down.tolist()) - set(node_ids.tolist())) + (0,))
        self._topo = topo
        n = topo.n_nodes
        seg_rows, _ = self._pushed_rows()

        def col(name, default=1.0):
            out = np.full(n, default, np.float32)
            arr = np.asarray(v.get(name, np.zeros(0)), np.float64)
            m = min(arr.size, seg_ids.size)
            out[seg_rows[:m]] = arr[:m]
            return out

        self._chan = ChannelParams.from_arrays(
            device=dev, dtype=f32,
            **{k: col(k) for k in ("dx", "bw", "tw", "twcc", "n", "ncc",
                                   "cs", "s0")})

        n_res = topo.reservoir_rows.size
        parm = np.ones((max(n_res, 1), 9))
        elev0 = np.zeros(max(n_res, 1), np.float32)
        q0 = np.zeros(n, np.float32)
        d0 = np.zeros(n, np.float32)
        if n_res:
            slot_of_lake = {int(topo.ids[r]): s
                            for s, r in enumerate(topo.reservoir_rows)}
            for k, lk in enumerate(wb_ids):
                s = slot_of_lake.get(int(lk))
                if s is None:
                    continue
                for j, name in enumerate(("LkArea", "LkMxE", "OrificeA",
                                          "OrificeC", "OrificeE", "WeirC",
                                          "WeirE", "WeirL", "ifd")):
                    arr = np.asarray(v.get(name, np.zeros(0)), np.float64)
                    if k < arr.size:
                        parm[s, j] = arr[k]
                h0 = np.asarray(v.get("h0", np.zeros(0)), np.float64)
                qd0 = np.asarray(v.get("qd0", np.zeros(0)), np.float64)
                elev0[s] = h0[k] if k < h0.size else (
                    parm[s, 4] + (parm[s, 1] - parm[s, 4]) * parm[s, 8])
                r = topo.reservoir_rows[s]
                q0[r] = qd0[k] if k < qd0.size else 0.0
                d0[r] = elev0[s]
        self._lp = LevelpoolParams.from_array(parm.astype(np.float32),
                                              device=dev, dtype=f32)
        self._net = network_arrays_from_topology(topo, device=dev)
        self._q = torch.as_tensor(q0, device=dev)
        self._d = torch.as_tensor(d0, device=dev)
        self._elev = torch.as_tensor(elev0, device=dev)
        self._network_ready = True

    def update(self) -> None:
        self.update_until(self._time + self._dt)

    def _build_gage_da(self, nts):
        """Streamflow-nudging DA inputs from the BmiDAforcing transport
        arrays (reference troute_model ingests usgs_df/lastobs_df rebuilt
        by bmi_array2df, troute_model.py:204-240)."""
        from troute_torch.bmi import codec
        from troute_torch.routing.engine import GageDA

        v = self._values
        flat = np.asarray(
            v.get("usgs_gage_observation__volume_flow_rate", np.zeros(0)),
            np.float64)
        secs = np.asarray(v.get("datesSecondsArray_usgs", np.zeros(0)),
                          np.float64)
        gseg = np.asarray(v.get("gage_segment_id", np.zeros(0)), np.int64)
        if not (flat.size and secs.size and gseg.size):
            return None
        stations = codec.decode_strings(
            v["stationArray_usgs"], v["stationStringLengthArray_usgs"])
        obs_tbl = flat.reshape(len(stations), -1)
        gage_st = codec.decode_strings(
            v.get("gage_stationArray", np.zeros(0, np.uint8)),
            v.get("gage_stationStringLengthArray", np.zeros(0, np.int32)))
        if len(gage_st) != gseg.size:
            return None
        st_row = {s.strip(): k for k, s in enumerate(stations)}
        seg_rows, seg_found = self._rows_of(gseg)

        rows, obs_rows = [], []
        # per-timestep column: nearest transport date within dt/2
        t_steps = self._time + np.arange(nts + 1) * self._dt
        col = np.searchsorted(secs, t_steps)
        col = np.clip(col, 0, secs.size - 1)
        colm = np.clip(col - 1, 0, secs.size - 1)
        use_prev = np.abs(secs[colm] - t_steps) <= np.abs(
            secs[col] - t_steps)
        col = np.where(use_prev, colm, col)
        hit = np.abs(secs[col] - t_steps) <= self._dt / 2.0

        lo_val, lo_time = [], []
        lo_gages = codec.decode_strings(
            v.get("lastObs_gageArray", np.zeros(0, np.uint8)),
            v.get("lastObs_gageStringLengths", np.zeros(0, np.int32)))
        lo_map = {g.strip(): k for k, g in enumerate(lo_gages)}
        lo_disc = np.asarray(v.get("lastObs_discharge", np.zeros(0)),
                             np.float64)
        lo_since = np.asarray(v.get("lastObs_timeSince", np.zeros(0)),
                              np.float64)
        kept_gages = []
        for i, st in enumerate(gage_st):
            k = st_row.get(st.strip())
            if k is None or not seg_found[i]:
                continue
            kept_gages.append(st.strip())
            rows.append(seg_rows[i])
            obs_rows.append(np.where(hit, obs_tbl[k, col], np.nan))
            j = lo_map.get(st.strip())
            if j is not None and j < lo_disc.size:
                lo_val.append(lo_disc[j])
                lo_time.append(-abs(lo_since[j]))
            else:
                lo_val.append(np.nan)
                lo_time.append(0.0)
        if not rows:
            return None
        self._da_gages = kept_gages
        dev, f32 = self._device, torch.float32
        return GageDA(
            rows=torch.as_tensor(np.asarray(rows, np.int64), device=dev),
            obs=torch.as_tensor(np.asarray(obs_rows, np.float32).T,
                                device=dev),
            lastobs_val=torch.as_tensor(np.asarray(lo_val), dtype=f32,
                                        device=dev),
            lastobs_time=torch.as_tensor(np.asarray(lo_time), dtype=f32,
                                         device=dev),
            decay_coeff=120.0)

    def update_until(self, until: float) -> None:
        """Route from the current time to ``until``: the pushed arrays go
        to the device (span ``bmi.ingest``), the engine runs
        (``engine.route``), and the outputs come back to the host
        (``bmi.publish``), all inside the span ``bmi.update_until``."""
        with span("bmi.update_until"):
            self._update_until(until)

    def _update_until(self, until: float) -> None:
        from troute_torch.routing.engine import (RoutingConfig, route,
                                                 route_stepped)

        with span("bmi.ingest"):
            if not self._network_ready:
                self._build_network()
            nts = max(int(round((until - self._time) / self._dt)), 1)

            v = self._values
            dev = self._device
            n = self._topo.n_nodes
            ql = np.zeros((1, n), np.float32)
            qsrc = np.asarray(
                v.get("land_surface_water_source__volume_flow_rate",
                      np.zeros(0)), np.float64)
            seg_ids = np.asarray(v["segment_id"], np.int64)
            m = min(seg_ids.size, qsrc.size)
            seg_rows, seg_found = self._pushed_rows()
            rows, found = seg_rows[:m], seg_found[:m]
            ql[0, rows[found]] = qsrc[:m][found]

            # domain-split upstream boundary hand-off: [id, q, v, d] tuples
            up_fvd = np.asarray(v.get("upstream_fvd", np.zeros(0)),
                                np.float64)
            up_ids = np.asarray(v.get("upstream_id", np.zeros(0)), np.int64)
            q = self._q
            if up_ids.size:
                up_rows, up_found = self._rows_of(up_ids)
                up_rows = up_rows[up_found]
                vals = up_fvd.reshape(up_ids.size, -1)[:, 0]
                q = q.clone()
                q[torch.as_tensor(up_rows, device=dev)] = torch.as_tensor(
                    vals[:up_rows.size], dtype=q.dtype, device=dev)

            # honor the config's timestep coupling like the reference BMI
            # (troute_model.py passes compute_parameters straight through);
            # strict runs in its fixed-point form (levels aren't built here)
            short_ts = bool(self._cfg.compute_parameters.assume_short_ts) \
                if self._cfg is not None else True
            cfg = RoutingConfig(dt=self._dt, nts=nts, qts_subdivisions=1,
                                assume_short_ts=short_ts,
                                strict_iterative=not short_ts)
            q_before = _host(q) if self._hyb is not None else None
            da = self._build_gage_da(nts)
            qlat = torch.as_tensor(ql, device=dev)
        engine = route_stepped if short_ts else route
        out = engine(self._net, self._chan, self._lp, cfg, q, self._d,
                     self._elev, qlat, da)

        # hybrid diffusive mainstem window (config-driven mode only)
        ms_qd = {}
        if self._hyb is not None:
            ms_qd = self._update_diffusive(q_before, out["flowveldepth"],
                                           nts)

        with span("bmi.publish"):
            self.last_update_counts = {k: out[k] for k in (
                "strict_sweeps", "mc_calls") if k in out}
            st = out["state"]
            self._q, self._d, self._elev = st.q, st.depth, st.res_elev
            if da is not None:
                # hand the updated lastobs state back through the transport
                # vars (time re-based so it stays relative to current
                # time), re-keyed to the gages actually used this run
                from troute_torch.bmi import codec
                codes, lens = codec.encode_strings(self._da_gages)
                v["lastObs_gageArray"] = codes
                v["lastObs_gageStringLengths"] = lens
                lo_val = _host(st.lastobs_val).astype(np.float64)
                v["lastObs_discharge"] = lo_val
                v["lastObs_timeSince"] = np.asarray(
                    nts * self._dt - _host(st.lastobs_time), np.float64)
                v["lastobs__volume_flow_rate"] = lo_val.copy()
            fvd = _host(out["flowveldepth"][-1])

            rows, found = seg_rows, seg_found
            q_out = np.zeros(seg_ids.size)
            v_out = np.zeros(seg_ids.size)
            d_out = np.zeros(seg_ids.size)
            q_out[found] = fvd[rows[found], 0]
            v_out[found] = fvd[rows[found], 1]
            d_out[found] = fvd[rows[found], 2]
            for k in np.flatnonzero(~found):
                q_out[k], d_out[k] = ms_qd.get(int(seg_ids[k]), (0.0, 0.0))
            v["channel_exit_water_x-section__volume_flow_rate"] = q_out
            v["channel_water_flow__speed"] = v_out
            v["channel_water__mean_depth"] = d_out
            res_rows = self._topo.reservoir_rows
            if res_rows.size:
                v["lake_water~outgoing__volume_flow_rate"] = \
                    fvd[res_rows, 0].astype(np.float64)
                v["lake_surface__elevation"] = _host(self._elev).astype(
                    np.float64)
            self._time = until

    def _update_diffusive(self, q_before, fvd_all, nts):
        """Advance the diffusive mainstem over this update window, carrying
        state across updates.  Returns {mainstem seg id: (q, depth)} at the
        window end."""
        from troute_torch.diffusive.solver import (initialize_state,
                                                   run_diffusive)

        self._ingest_coastal_transport()
        hyb = self._hyb
        dev = self._device
        rows, found = self._rows_of(np.asarray(hyb.trib_segments, np.int64))
        trib_q = np.zeros((nts + 1, rows.size))
        trib_q[0, found] = q_before[rows[found]]
        trib_q[1:, found] = _host(fvd_all[:, torch.as_tensor(
            rows[found], device=dev), 0])

        # window-constant mainstem qlat from the pushed per-segment array
        seg_ids = np.asarray(self._values["segment_id"], np.int64)
        qsrc = np.asarray(
            self._values.get("land_surface_water_source__volume_flow_rate",
                             np.zeros(0)), np.float64)
        qlat_rows = {}
        for k, s in enumerate(seg_ids):
            if int(s) in hyb.mainstem_set and k < qsrc.size:
                qlat_rows[int(s)] = np.full(2, qsrc[k])

        window = nts * self._dt
        if self._coastal is not None:
            db, dt_db, t_ref = self._coastal
            skip = max(0, int(np.floor((self._time - t_ref) / dt_db)))
            sl = db[:, skip:]
            hyb.coastal_db = sl if sl.shape[1] >= 2 else None
            hyb.coastal_dt_db = dt_db
        dtype = (torch.float32 if self._diff_dtype_str == "float32"
                 else torch.float64)
        dom = hyb.build_diffusive_domain(
            qlat_rows, dt_qlat=window, trib_q=trib_q, dt_trib=self._dt,
            dtini=self._dt, device=dev, dtype=dtype,
            nel_uniform=self._diff_nel)
        if self._dst is None:
            q_init = np.maximum(np.broadcast_to(
                trib_q[0].sum() / max(dom.n_reaches, 1),
                (dom.n_reaches, dom.n_cols)), 0.1)
            self._dst = initialize_state(dom, q_init,
                                         dtini_min=self._dt / 10.0)
        dst = self._dst._replace(t=torch.zeros((), dtype=dtype, device=dev))
        mode = self._cfg.compute_parameters.hybrid_parameters \
            .diffusive_corrector
        dst, saves = run_diffusive(dom, dst, t_final=window,
                                   save_interval=self._dt,
                                   corrector_mode=mode)
        self._dst = dst
        q_seg, d_seg = hyb.saves_to_segments(saves, dom)
        return {s: (float(q_seg[s][-1]), float(d_seg[s][-1]))
                for s in q_seg}

    def finalize(self) -> None:
        self._values.clear()
        self._initialized = False

    # ------------------------------------------------- variable info
    def get_component_name(self):
        return "troute_torch: PyTorch/CUDA T-Route"

    def get_input_item_count(self):
        return len(_INPUT_VARS)

    def get_output_item_count(self):
        return len(_OUTPUT_VARS)

    def get_input_var_names(self):
        return list(_INPUT_VARS)

    def get_output_var_names(self):
        return list(_OUTPUT_VARS)

    def get_var_units(self, name):
        return _UNITS.get(name, "-")

    def get_var_type(self, name):
        return str(self.get_value_ptr(name).dtype)

    def get_var_itemsize(self, name):
        return self.get_value_ptr(name).itemsize

    def get_var_nbytes(self, name):
        return self.get_value_ptr(name).nbytes

    def get_var_grid(self, name):
        return 0

    def get_var_location(self, name):
        return "node"

    # ------------------------------------------------- time functions
    def get_current_time(self):
        return self._time

    def get_start_time(self):
        return 0.0

    def get_end_time(self):
        return self._end_time

    def get_time_step(self):
        return self._dt

    def get_time_units(self):
        return "seconds"

    # ------------------------------------------------- get/set
    def get_value_ptr(self, name):
        return self._values[name]

    def get_value(self, name, dest=None):
        val = np.asarray(self._values[name])
        if dest is None:
            return val.copy()
        dest[:val.size] = val
        return dest

    def set_value(self, name, values):
        self._values[name] = np.asarray(values)
        if name in _SEGMENT_VARS or name in _WATERBODY_VARS:
            self._network_ready = False

    def get_value_at_indices(self, name, dest, inds):
        dest[:] = np.asarray(self._values[name])[inds]
        return dest

    def set_value_at_indices(self, name, inds, src):
        arr = np.asarray(self._values[name])
        arr[inds] = src
        self._values[name] = arr

    # grid functions (scalar/1-D network, reference parity)
    def get_grid_rank(self, grid):
        return 1

    def get_grid_size(self, grid):
        return self._topo.n_nodes if self._network_ready else 0

    def get_grid_type(self, grid):
        return "scalar"

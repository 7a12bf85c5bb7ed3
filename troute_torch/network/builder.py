"""Network assembly: config + domain files -> device-ready arrays.

The array-first equivalent of the reference's ``NHDNetwork`` construction
(``NHDNetwork.py:117-345`` + ``AbstractNetwork.__init__``): read RouteLink,
apply the domain mask, collapse waterbodies to lake nodes, build the
columnar topology, assemble channel/reservoir parameter arrays and the gage
crosswalk, and resolve warm-start state.

A copy of ``troute_tpu/network/builder.py`` whose per-node Python loops
(node types, channel parameters, restart state, gage rows) are NumPy
lookups by id (``positions_of``) that give the same arrays; the stages' host
seconds are logged at INFO.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from troute_torch.config.schema import Config
from troute_torch.io.routelink import (RouteLinkData, read_lakeparm,
                                     read_routelink)
from troute_torch.io.restart import (
    read_wrf_hydro_channel_restart, read_wrf_hydro_waterbody_restart)
from troute_torch.network import graph
from troute_torch.network.topology import (
    NODE_RESERVOIR, RoutingTopology, build_topology)

LOG = logging.getLogger(__name__)


def positions_of(keys: np.ndarray, queries) -> tuple:
    """For each of ``queries``, the position in ``keys`` of its LAST
    occurrence (what a dict built by enumerating ``keys`` holds) and
    whether it occurs at all; positions of absent queries are 0."""
    keys = np.asarray(keys, np.int64)
    queries = np.asarray(queries, np.int64)
    if keys.size == 0:
        return (np.zeros(queries.size, np.int64),
                np.zeros(queries.size, bool))
    order = np.argsort(keys, kind="stable")
    at = np.searchsorted(keys[order], queries, side="right") - 1
    found = (at >= 0) & (keys[order[np.maximum(at, 0)]] == queries)
    return np.where(found, order[np.maximum(at, 0)], 0), found


@dataclass
class BuiltNetwork:
    """Everything the engine needs, in topology row order."""

    topo: RoutingTopology
    chan: dict                   # {dx..s0: float32 [N]} (lake rows: benign)
    res_params: np.ndarray       # [n_res, 9] levelpool params incl. ifd col 8
    res_elev0: np.ndarray        # [n_res] initial water elevation
    res_outflow0: np.ndarray     # [n_res] initial outflow
    q0: np.ndarray               # [N] initial flow (qd0)
    qu0: np.ndarray              # [N] initial upstream flow (legacy)
    depth0: np.ndarray           # [N] initial depth / lake elevation
    gage_rows: np.ndarray        # int32 [n_gages] topo rows with gages
    gage_ids: np.ndarray         # str  [n_gages]
    lake_crosswalk: dict         # lake id -> outlet segment id
    segment_rows: np.ndarray     # rows that are MC segments
    nexus_of_wb: dict | None = None   # HYFeatures: wb id -> upstream nexus
    wb_downstream_nexus: dict | None = None  # HYFeatures: wb id -> downstream nexus
    hyf_da: object | None = None      # HYFeatures: HyfDAInfo gage crosswalks

    @property
    def n_nodes(self):
        return self.topo.n_nodes


def build_network(cfg: Config, base: Path,
                  exclude_ids=None) -> BuiltNetwork:
    """``exclude_ids``: segment ids carved out of the MC domain (the
    diffusive mainstem — reference ``AbstractRouting.update_routing_domain``,
    ``AbstractRouting.py:209-327``).

    Preprocessing cache: with
    ``network_topology_parameters.preprocessing_parameters`` the assembled
    network is pickled to / restored from disk (reference
    ``preprocess.py:534-590`` semantics), skipping graph construction on
    warm starts.
    """
    import pickle

    t_stage = [time.perf_counter()]
    base = Path(base)
    ntp = cfg.network_topology_parameters
    pp = getattr(ntp, "preprocessing_parameters", None)
    cache_path = None
    if pp is not None and (pp.use_preprocessed_data or pp.preprocess_only) \
            and (pp.preprocess_output_folder or pp.preprocess_source_file):
        if pp.use_preprocessed_data and pp.preprocess_source_file:
            src_path = base / pp.preprocess_source_file
            if src_path.exists():
                with open(src_path, "rb") as f:
                    return pickle.load(f)
        cache_path = base / (pp.preprocess_output_folder or ".") \
            / f"{pp.preprocess_output_filename}.pkl"
        if pp.use_preprocessed_data and cache_path.exists():
            with open(cache_path, "rb") as f:
                return pickle.load(f)
    sp = ntp.supernetwork_parameters
    wbp = ntp.waterbody_parameters

    columns = sp.columns.model_dump() if sp.columns else None
    mask_ids = None
    if sp.mask_file_path:
        mask_ids = np.loadtxt(base / sp.mask_file_path, dtype=np.int64,
                              ndmin=1)
    geo = base / sp.geo_file_path
    nexus_of_wb = None
    wb_ds_nexus = None
    hyf_da = None
    is_hyfeatures = str(geo).endswith(".gpkg")
    if is_hyfeatures:
        from troute_torch.network.hyfeatures import read_geopkg
        rl, nexus_of_wb, wb_ds_nexus, hyf_da = read_geopkg(geo, columns)
        if mask_ids is not None:
            keep = np.isin(rl.ids, mask_ids)
            rl = RouteLinkData(
                ids=rl.ids[keep], downstream=rl.downstream[keep],
                channel={k: v[keep] for k, v in rl.channel.items()},
                waterbody=rl.waterbody[keep],
                waterbody_null=rl.waterbody_null, gages=rl.gages[keep],
                alt=None)
    else:
        rl = read_routelink(geo, columns, mask_ids)
    if sp.synthetic_wb_segments:
        # disambiguate synthetic coastal reservoir segment ids
        # (reference AbstractNetwork.set_synthetic_wb_segments:425-441:
        # only the key column is offset)
        ids = rl.ids.copy()
        fix = np.isin(ids, np.asarray(sp.synthetic_wb_segments, np.int64))
        ids[fix] = ids[fix] + np.int64(sp.synthetic_wb_id_offset)
        rl = RouteLinkData(ids=ids, downstream=rl.downstream,
                           channel=rl.channel, waterbody=rl.waterbody,
                           waterbody_null=rl.waterbody_null, gages=rl.gages,
                           alt=rl.alt)
    if exclude_ids is not None:
        keep = ~np.isin(rl.ids, np.asarray(list(exclude_ids), np.int64))
        rl = RouteLinkData(
            ids=rl.ids[keep], downstream=rl.downstream[keep],
            channel={k: v[keep] for k, v in rl.channel.items()},
            waterbody=rl.waterbody[keep], waterbody_null=rl.waterbody_null,
            gages=rl.gages[keep],
            alt=rl.alt[keep] if rl.alt is not None else None)

    t_stage.append(time.perf_counter())
    # waterbody mapping (only when simulating waterbodies)
    waterbodies: dict[int, int] = {}
    lake_params = None
    if wbp.break_network_at_waterbodies and wbp.level_pool:
        lp_file = wbp.level_pool.level_pool_waterbody_parameter_file_path
        if is_hyfeatures:
            from troute_torch.io.routelink import LakeParmData
            from troute_torch.network.hyfeatures import read_lake_attributes
            lids, parms, outlet_wb = read_lake_attributes(
                base / (lp_file or sp.geo_file_path))
            if outlet_wb is not None:
                # new-format lakes layer: hl_link lake ids with the outlet
                # wb flowpath in 'id'; lake ids colliding with segment ids
                # get the reference's synthetic offset
                # (HYFeaturesNetwork.py:477-504)
                seg_set = set(int(s) for s in rl.ids)
                remap = {int(l): (int(l) + int(9.99e11)
                                  if int(l) in seg_set else int(l))
                         for l in lids}
                lids = np.asarray([remap[int(l)] for l in lids], np.int64)
                if hyf_da is not None:
                    # DA crosswalks are keyed by lake id too — follow the
                    # same synthetic offset or assemble_reservoir_da's
                    # type_of/gage_of lookups (keyed by topo node id)
                    # silently miss offset lakes
                    rekey = lambda d: {remap.get(int(k), int(k)): v
                                       for k, v in d.items()}
                    hyf_da = hyf_da._replace(
                        usgs_lake_gage=rekey(hyf_da.usgs_lake_gage),
                        usace_lake_gage=rekey(hyf_da.usace_lake_gage),
                        rfc_lake_gage=rekey(hyf_da.rfc_lake_gage))
                known = set(lids.tolist())
                for lk, wb_seg in outlet_wb.items():
                    lk = remap.get(int(lk), int(lk))
                    if lk in known and int(wb_seg) in seg_set:
                        waterbodies[int(wb_seg)] = lk
                # member segments via the waterbody attribute column
                wb_mask = rl.waterbody != rl.waterbody_null
                for seg, lake in zip(rl.ids[wb_mask], rl.waterbody[wb_mask]):
                    lk = remap.get(int(lake), int(lake))
                    if lk in known:
                        waterbodies[int(seg)] = lk
            else:
                # old-format gpkg lakes are flowpaths themselves
                # (wb id == lake id)
                for seg in rl.ids[np.isin(rl.ids, lids)].tolist():
                    waterbodies[seg] = seg
            lake_params = LakeParmData(lake_ids=lids, params=parms)
        else:
            wb_mask = rl.waterbody != rl.waterbody_null
            lake_ids_in_domain = set(
                np.unique(rl.waterbody[wb_mask]).tolist())
            lake_params = read_lakeparm(
                base / lp_file, wbp.level_pool.level_pool_waterbody_id,
                lake_ids_in_domain)
            known = set(lake_params.lake_ids.tolist())
            for seg, lake in zip(rl.ids[wb_mask], rl.waterbody[wb_mask]):
                if int(lake) in known:
                    waterbodies[int(seg)] = int(lake)

    # connections with terminal handling: explicit terminal code plus
    # off-domain pointers
    terminals = {sp.terminal_code} | (
        set(rl.downstream.tolist()) - set(rl.ids.tolist()))
    conn = graph.extract_connections(rl.ids.tolist(), rl.downstream.tolist(),
                                     terminals)
    lake_crosswalk: dict = {}
    if waterbodies:
        conn, lake_crosswalk = graph.replace_waterbodies(conn, waterbodies)

    # columnar topology from the collapsed graph
    node_ids = np.fromiter(conn.keys(), np.int64, len(conn))
    down = np.fromiter((d[0] if d else -9999 for d in conn.values()),
                       np.int64, len(conn))
    node_type = np.where(
        np.isin(node_ids, np.fromiter(lake_crosswalk, np.int64,
                                      len(lake_crosswalk))),
        NODE_RESERVOIR, 0).astype(np.int8)
    t_stage.append(time.perf_counter())
    # postorder rows: nearly every edge lands at row displacement 1, so
    # the engine's banded upstream-sum plan covers the network with a few
    # masked shifts instead of a latency-bound gather (upstream_plan.py)
    topo = build_topology(node_ids, down, node_type,
                          terminal_codes=(-9999,), on_cycle="drop",
                          row_order="postorder")

    t_stage.append(time.perf_counter())
    n = topo.n_nodes

    # channel parameters in row order (benign defaults on lake rows)
    seg_pos, is_seg = positions_of(rl.ids, topo.ids)
    chan = {k: np.ones(n, np.float32) for k in
            ("dx", "bw", "tw", "twcc", "n", "ncc", "cs", "s0")}
    for k in chan:
        chan[k][is_seg] = rl.channel[k][seg_pos[is_seg]]

    # reservoir parameter block in topo.reservoir_rows order
    res_rows = topo.reservoir_rows
    n_res = res_rows.size
    res_params = np.ones((max(n_res, 1), 9), np.float64)
    if n_res and lake_params is not None:
        lake_pos, known_lake = positions_of(lake_params.lake_ids,
                                          topo.ids[res_rows])
        if not known_lake.all():
            raise KeyError(int(topo.ids[res_rows][~known_lake][0]))
        res_params[:n_res] = lake_params.params[lake_pos]

    # initial conditions (cold start default)
    q0 = np.zeros(n, np.float32)
    qu0 = np.zeros(n, np.float32)
    depth0 = np.zeros(n, np.float32)
    res_elev0 = np.full(max(n_res, 1), np.nan, np.float32)
    res_outflow0 = np.zeros(max(n_res, 1), np.float32)

    def scatter(ids, keys, pairs):
        """dst[position of id in keys] = src for each (dst, src), over
        the ids that occur in ``keys``, in file order (the last wins)."""
        at, ok = positions_of(keys, ids)
        for dst, src in pairs:
            dst[at[ok]] = np.asarray(src)[ok]

    def column(df, name, default):
        return (df[name].to_numpy() if name in df.columns
                else np.full(len(df), default))

    rp = cfg.compute_parameters.restart_parameters
    if rp.lite_channel_restart_file:
        from troute_torch.io.restart import read_lite_restart
        df = read_lite_restart(base / rp.lite_channel_restart_file)
        scatter(df.index.to_numpy(), topo.ids,
                [(qu0, column(df, "qu0", 0.0)), (q0, column(df, "qd0", 0.0)),
                 (depth0, column(df, "h0", 0.0))])
    if rp.lite_waterbody_restart_file and n_res:
        from troute_torch.io.restart import read_lite_restart
        df = read_lite_restart(base / rp.lite_waterbody_restart_file)
        scatter(df.index.to_numpy(), topo.ids[res_rows],
                [(res_elev0, column(df, "h0", np.nan)),
                 (res_outflow0, column(df, "qd0", 0.0))])
    if rp.wrf_hydro_channel_restart_file:
        ids_r, qu, qd, h = read_wrf_hydro_channel_restart(
            base / rp.wrf_hydro_channel_restart_file,
            base / (rp.wrf_hydro_channel_ID_crosswalk_file
                    or sp.geo_file_path))
        scatter(ids_r, topo.ids, [(qu0, qu), (q0, qd), (depth0, h)])
    if rp.wrf_hydro_waterbody_restart_file and n_res:
        lids, resht, qlakeo = read_wrf_hydro_waterbody_restart(
            base / rp.wrf_hydro_waterbody_restart_file,
            base / (rp.wrf_hydro_waterbody_ID_crosswalk_file or ""))
        scatter(lids, topo.ids[res_rows],
                [(res_elev0, resht), (res_outflow0, qlakeo)])

    # cold-start elevation where no restart value
    # (reference levelpool_structs.c:97-106)
    if n_res:
        cold = (res_params[:n_res, 4]
                + (res_params[:n_res, 1] - res_params[:n_res, 4])
                * res_params[:n_res, 8])
        nanmask = ~np.isfinite(res_elev0[:n_res])
        res_elev0[:n_res] = np.where(nanmask, cold, res_elev0[:n_res])
        # engine convention: lake rows carry outflow/elevation in q/depth
        q0[res_rows] = res_outflow0[:n_res]
        depth0[res_rows] = res_elev0[:n_res]

    # gage crosswalk (segments only; reaches split at gages happens
    # implicitly at node granularity), in RouteLink order
    gage_row, in_topo = positions_of(topo.ids, rl.ids)
    gaged = np.asarray(rl.gages, dtype=object).astype(bool) & in_topo
    gage_rows = gage_row[gaged].astype(np.int32)
    gage_ids = list(np.asarray(rl.gages, dtype=object)[gaged])

    seg_rows = np.flatnonzero(topo.node_type == 0).astype(np.int32)

    built = BuiltNetwork(
        topo=topo, chan=chan, res_params=res_params,
        res_elev0=res_elev0, res_outflow0=res_outflow0,
        q0=q0, qu0=qu0, depth0=depth0,
        gage_rows=gage_rows,
        gage_ids=np.asarray(gage_ids, dtype=object),
        lake_crosswalk=lake_crosswalk, segment_rows=seg_rows,
        nexus_of_wb=nexus_of_wb,
        wb_downstream_nexus=wb_ds_nexus, hyf_da=hyf_da)
    if cache_path is not None:
        cache_path.parent.mkdir(parents=True, exist_ok=True)
        # written aside and renamed into place, so that another process
        # (a rank of a sharded run) reads the whole network or none of it
        tmp = cache_path.with_name(f".{cache_path.name}.{os.getpid()}")
        with open(tmp, "wb") as f:
            pickle.dump(built, f)
        os.replace(tmp, cache_path)
    t_stage.append(time.perf_counter())
    LOG.info("network stages: read %.2f s, graph %.2f s, topology %.2f s, "
             "arrays %.2f s", *np.diff(t_stage))
    return built

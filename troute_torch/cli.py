"""Command-line simulation entry point.

Equivalent of the reference CLI orchestrator
(``troute-nwm/src/nwm_routing/__main__.py:main_v04``): parse the YAML
control file, build the network, assemble forcing run sets, run routing
with warm-state hand-off between sets, apply data assimilation, and emit
outputs — `python -m troute_torch -f config.yaml`.

Port of ``troute_tpu/cli.py`` for the Muskingum-Cunge engine.  It routes
on the first CUDA device unless ``--cpu`` is given, and with neither a
device nor ``--cpu`` it raises; it never picks the CPU by itself.  Both
``assume_short_ts: True`` and ``strict_iterative: True`` go through
``route_stepped`` whatever ``compute_kernel`` says (the stepped engine
takes the MC kernels for CUDA tensors and their plain versions for CPU
tensors); the schema's default, ``assume_short_ts: False`` without
``strict_iterative``, goes through ``route()``'s level scan, as in the JAX
CLI.  Tensors are made once per run on that device in float32; the
state handed from run set to run set stays there, and flows, nudges and
Courant numbers come to the host once per run set.  Hybrid routing
(``run_hybrid_routing`` with a ``diffusive_domain``) carves the mainstem
out of the MC network and routes it after the MC run with
``routing/hybrid.py:run_mainstem``, on the same device.
``parallel_compute_method: sharded`` shards a short or fixed-point run
without Courant numbers across the ranks of a process group, one process
per GPU, where the JAX CLI shards across its devices: under ``torchrun``
(``python -m torch.distributed.run --nproc_per_node=N -m troute_torch -f
cfg.yaml``) the command line makes the group (NCCL on the card, gloo with
``--cpu``), or it joins the default group its caller made.  It
partitions the network once (``parallel/partition.py``), routes each run
set with ``parallel/sharded_engine.py:route_sharded_global``, and shards
the hybrid run's batch lanes; every rank returns the same result, and
rank 0 alone writes files.  A single process is a group of one and routes
on one device, as the JAX CLI does with one device.
"""

from __future__ import annotations

import argparse
import logging
import os
import re
import time
from pathlib import Path

import numpy as np
import pandas as pd
import torch
import torch.distributed as dist

LOG = logging.getLogger("troute_torch")


def _tensor(a, dtype, device) -> torch.Tensor:
    """``a`` on ``device``, contiguous as the kernels take it (a reader
    may hand over a transposed array)."""
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                           device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _file_stamp(path):
    """Model time encoded in a forcing filename (``202108231300.CHRTOUT_…``
    / ``202108231300NEXOUT…`` — the reference derives run-set file lists
    from these stamps, ``AbstractNetwork.py:856-869``), or None."""
    m = re.match(r"(\d{12})", Path(path).name)
    if not m:
        return None
    try:
        return pd.to_datetime(m.group(1), format="%Y%m%d%H%M")
    except ValueError:
        return None


def build_forcing_sets(files, dt, qts_subdivisions, nts, max_loop_size_hrs):
    """Group qlat forcing files into run sets (reference
    ``AbstractNetwork.build_forcing_sets``, ``AbstractNetwork.py:742``)."""
    steps_per_file = qts_subdivisions
    files_per_set = max(
        1, int(max_loop_size_hrs * 3600 / (dt * steps_per_file)))
    total_steps = 0
    sets = []
    for i in range(0, len(files), files_per_set):
        chunk = files[i:i + files_per_set]
        n_steps = len(chunk) * steps_per_file
        if nts and total_steps + n_steps > nts:
            n_steps = nts - total_steps
            if n_steps <= 0:
                break
        sets.append({"qlat_files": chunk, "nts": n_steps})
        total_steps += n_steps
        if nts and total_steps >= nts:
            break
    return sets


def assemble_gage_da(cfg, built, base, t0, nts, dt, dtype, device):
    """Streamflow-nudging inputs from TimeSlice folders, as tensors of
    ``dtype`` on ``device``, or None."""
    from troute_torch.io.timeslice import get_obs_from_timeslices
    from troute_torch.routing.engine import GageDA

    dap = cfg.compute_parameters.data_assimilation_parameters
    sda = dap.streamflow_da
    if not (sda and sda.streamflow_nudging and dap.usgs_timeslices_folder):
        return None
    if built.gage_rows.size == 0:
        return None

    folder = base / dap.usgs_timeslices_folder
    lookback = pd.Timedelta(hours=dap.timeslice_lookback_hours or 24)
    files = sorted(folder.glob("*.usgsTimeSlice.ncdf"))

    def _ts(f):
        return pd.to_datetime(f.name.split(".")[0],
                              format="%Y-%m-%d_%H:%M:%S")
    files = [f for f in files
             if t0 - lookback <= _ts(f) <= t0 + pd.Timedelta(seconds=nts * dt)]
    if not files:
        LOG.warning("streamflow DA enabled but no TimeSlice files in window")
        return None

    obs_df = get_obs_from_timeslices(
        built.gage_ids, files, qc_threshold=dap.qc_threshold or 1.0,
        interpolation_limit=dap.interpolation_limit_min or 59,
        frequency_secs=dt, t0=t0, nts=nts)
    if obs_df.empty:
        return None

    n_g = built.gage_rows.size
    obs = np.full((nts + 1, n_g), np.nan, np.float32)
    gage_pos = {g: i for i, g in enumerate(built.gage_ids)}
    for gage, row in obs_df.iterrows():
        gi = gage_pos.get(str(gage))
        if gi is None:
            continue
        vals = row.to_numpy(np.float64)
        m = min(vals.size, nts + 1)
        obs[:m, gi] = vals[:m]

    # warm-start lastobs state from a nudgingLastObs file if provided
    lo_val = np.full(n_g, np.nan, np.float64)
    lo_time = np.full(n_g, np.nan, np.float64)
    if sda.lastobs_file:
        from troute_torch.io.restart import read_lastobs_file
        gids, disch, offs = read_lastobs_file(base / sda.lastobs_file)
        pos = {g: i for i, g in enumerate(gids)}
        for gi, g in enumerate(built.gage_ids):
            k = pos.get(str(g))
            if k is not None and np.isfinite(disch[k]) \
                    and disch[k] > -9000 and np.isfinite(offs[k]):
                lo_val[gi] = disch[k]
                lo_time[gi] = offs[k]

    return GageDA(
        rows=_tensor(built.gage_rows, torch.int64, device),
        obs=_tensor(obs, dtype, device),
        lastobs_val=_tensor(lo_val, dtype, device),
        lastobs_time=_tensor(lo_time, dtype, device),
        decay_coeff=float(dap.da_decay_coefficient))


def assemble_reservoir_da(cfg, built, base, t0, nts, dt, dtype, device):
    """Reservoir persistence/RFC DA inputs from the reservoir parameter
    file + TimeSlice folders (reference ``PersistenceDA.__init__`` +
    ``_prep_reservoir_da_dataframes``), as tensors of ``dtype`` on
    ``device``, or None when disabled."""
    from troute_torch.io.netcdf import NetCDFFile
    from troute_torch.io.timeslice import get_obs_from_timeslices
    from troute_torch.ops.reservoir_da import HybridDAState
    from troute_torch.routing.engine import ReservoirDAData

    from troute_torch.network.gl_constants import (
        GL_CANADA_GAGES, GL_USGS_GAGES, GREAT_LAKE_IDS)

    dap = cfg.compute_parameters.data_assimilation_parameters
    rda = dap.reservoir_da
    if rda is None:
        return None
    pda = rda.reservoir_persistence_da
    use_usgs = bool(pda and pda.reservoir_persistence_usgs)
    use_usace = bool(pda and pda.reservoir_persistence_usace)
    use_gl = bool(pda and pda.reservoir_persistence_greatLake)
    rfc = rda.reservoir_rfc_da
    use_rfc = bool(rfc and rfc.reservoir_rfc_forecasts)
    if not (use_usgs or use_usace or use_rfc or use_gl):
        return None
    # usgs/usace/rfc typing comes from the parameter file (NHD) or the
    # geopackage-derived crosswalks (HYFeatures); the Great Lakes are
    # identified by their hardcoded ids (reference great_lake class
    # needs no parameter file, DataAssimilation.py:710)
    hyf_da = getattr(built, "hyf_da", None)
    if not rda.reservoir_parameter_file and not use_gl and hyf_da is None:
        return None
    res_rows = built.topo.reservoir_rows
    n_res = res_rows.size
    if n_res == 0:
        return None

    type_of, gage_of, rfc_gage_of = {}, {}, {}
    if rda.reservoir_parameter_file:
        usgs_gage_f = (pda.crosswalk_usgs_gage_field
                       if pda else "usgs_gage_id")
        usace_gage_f = (pda.crosswalk_usace_gage_field
                        if pda else "usace_gage_id")
        usgs_lake_f = (getattr(pda, "crosswalk_usgs_lakeID_field", None)
                       or "usgs_lake_id") if pda else "usgs_lake_id"
        usace_lake_f = (getattr(pda, "crosswalk_usace_lakeID_field", None)
                        or "usace_lake_id") if pda else "usace_lake_id"
        with NetCDFFile(base / rda.reservoir_parameter_file) as f:
            lake_ids = f.read("lake_id").astype(np.int64)
            res_type = f.read("reservoir_type").astype(np.int32)
            usgs_lakes = f.read(usgs_lake_f).astype(np.int64)
            usgs_gages = f.read_strings(usgs_gage_f)
            usace_lakes = f.read(usace_lake_f).astype(np.int64)
            usace_gages = f.read_strings(usace_gage_f)
            rfc_lakes = f.read("rfc_lake_id").astype(np.int64)
            rfc_gages = f.read_strings("rfc_gage_id")
        type_of = dict(zip(lake_ids.tolist(), res_type.tolist()))
        if use_usgs:
            gage_of.update({int(l): g for l, g in zip(usgs_lakes, usgs_gages)})
        if use_usace:
            gage_of.update({int(l): g
                            for l, g in zip(usace_lakes, usace_gages)})
        rfc_gage_of = {int(l): g for l, g in zip(rfc_lakes, rfc_gages)}
    elif hyf_da is not None:
        # HYFeatures: types/gages derived from the geopackage itself
        # (HYFeaturesNetwork.preprocess_data_assimilation:606-703).  Order
        # matters: USGS type 2 overwrites USACE type 3 for lakes carrying
        # both designations, and RFC type 4 last (reference :683-699)
        if use_usace:
            for lk, g in hyf_da.usace_lake_gage.items():
                type_of[int(lk)] = 3
                gage_of[int(lk)] = g
        if use_usgs:
            for lk, g in hyf_da.usgs_lake_gage.items():
                type_of[int(lk)] = 2
                gage_of[int(lk)] = g
        if use_rfc:
            for lk, g in hyf_da.rfc_lake_gage.items():
                type_of[int(lk)] = 4
                rfc_gage_of[int(lk)] = g

    wtypes = np.ones(n_res, np.int32)
    res_gages = {}
    rfc_slots = {}
    gl_lakes = {}
    for slot, row in enumerate(res_rows):
        lk = int(built.topo.ids[row])
        if use_gl and lk in GREAT_LAKE_IDS:
            wtypes[slot] = 6
            gl_lakes[slot] = lk
            continue
        t = type_of.get(lk, 1)
        if (t == 2 and use_usgs) or (t == 3 and use_usace):
            wtypes[slot] = t
            if lk in gage_of:
                res_gages[slot] = gage_of[lk]
        elif t in (4, 5) and use_rfc and lk in rfc_gage_of:
            wtypes[slot] = t
            rfc_slots[slot] = rfc_gage_of[lk]

    # assemble gage observations at 15-min resolution on [0, nts*dt]
    obs_freq = 900.0
    n_obs = int(nts * dt / obs_freq) + 1
    obs = np.full((n_res, n_obs), np.nan, np.float32)
    obs_time = np.arange(n_obs) * obs_freq
    lookback = pd.Timedelta(hours=dap.timeslice_lookback_hours or 24)

    def _window_files(folder, pattern):
        """TimeSlice files within [t0 - lookback, t0 + run length]."""
        if not folder:
            return []
        files = sorted((base / folder).glob(pattern))
        return [f for f in files
                if t0 - lookback
                <= pd.to_datetime(f.name.split(".")[0],
                                  format="%Y-%m-%d_%H:%M:%S")
                <= t0 + pd.Timedelta(seconds=nts * dt)]

    def _collect(folder, pattern, slots):
        if not slots:
            return
        files = _window_files(folder, pattern)
        if not files:
            return
        gids = np.asarray([res_gages[s] for s in slots])
        df = get_obs_from_timeslices(
            gids, files, qc_threshold=dap.qc_threshold or 1.0,
            interpolation_limit=dap.interpolation_limit_min or 59,
            frequency_secs=obs_freq, t0=t0, nts=n_obs - 1)
        if df.empty:
            return
        for slot in slots:
            g = res_gages[slot]
            if g in df.index:
                vals = df.loc[g].to_numpy(np.float64)[:n_obs]
                obs[slot, :vals.size] = vals

    usgs_slots = [s for s, g in res_gages.items() if wtypes[s] == 2]
    usace_slots = [s for s, g in res_gages.items() if wtypes[s] == 3]
    _collect(dap.usgs_timeslices_folder, "*.usgsTimeSlice.ncdf", usgs_slots)
    _collect(dap.usace_timeslices_folder, "*.usaceTimeSlice.ncdf",
             usace_slots)

    # RFC forecast series (reference preprocess_RFC_data)
    rfc_fields = {}
    if rfc_slots:
        from troute_torch.io.rfc import preprocess_rfc_data
        from troute_torch.ops.reservoir_da import RfcDAState
        loaded = {}
        for slot, gage in rfc_slots.items():
            r = preprocess_rfc_data(
                t0, rfc.reservoir_rfc_forecasts_offset_hours, gage,
                base / rfc.reservoir_rfc_forecasts_time_series_path, dt)
            if r is not None:
                loaded[slot] = r
            else:
                wtypes[slot] = 1    # no file -> plain levelpool
        if loaded:
            n_counts = max(r["series"].size for r in loaded.values())
            series = np.zeros((n_res, n_counts))
            counts = np.zeros(n_res, np.int32)
            userfc = np.zeros(n_res, bool)
            step = np.full(n_res, 3600.0)
            idx0 = np.zeros(n_res, np.int32)
            ut0 = np.zeros(n_res)
            for slot, r in loaded.items():
                series[slot, :r["series"].size] = r["series"]
                counts[slot] = r["total_counts"]
                userfc[slot] = r["use_rfc"]
                step[slot] = r["time_step_seconds"]
                idx0[slot] = r["timeseries_idx"]
                ut0[slot] = r["update_time"]
            rfc_fields = dict(
                rfc_series=_tensor(series, dtype, device),
                rfc_counts=_tensor(counts, torch.int32, device),
                rfc_use=_tensor(userfc, torch.bool, device),
                rfc_timestep=_tensor(step, dtype, device),
                rfc_persist_seconds=torch.full(
                    (n_res,),
                    rfc.reservoir_rfc_forecast_persist_days * 86400.0,
                    dtype=dtype, device=device),
                rfc_state0=RfcDAState(
                    timeseries_idx=_tensor(idx0, torch.int32, device),
                    update_time=_tensor(ut0, dtype, device)))

    # Great Lakes: obs from TimeSlice gages / Lake Ontario CSV with the
    # hardcoded monthly climatology as fallback (reference _create_GL_dfs)
    gl_fields = {}
    if gl_lakes:
        from troute_torch.da_assembly import assemble_gl_inputs
        lake_gages = {}
        for lk in gl_lakes.values():
            if lk in GL_USGS_GAGES:
                lake_gages[lk] = GL_USGS_GAGES[lk]
            elif lk in GL_CANADA_GAGES:
                lake_gages[lk] = GL_CANADA_GAGES[lk]
        ontario = (base / dap.LakeOntario_outflow
                   if dap.LakeOntario_outflow
                   and 4800007 in gl_lakes.values() else None)
        gdata = assemble_gl_inputs(
            lake_gages, t0,
            usgs_files=_window_files(dap.usgs_timeslices_folder,
                                     "*.usgsTimeSlice.ncdf"),
            canada_files=_window_files(dap.canada_timeslices_folder,
                                       "*.wscTimeSlice.ncdf"),
            lake_ontario_csv=ontario)
        n_gobs = max([1] + [v.size for v, _, _ in gdata.values()])
        g_obs = np.full((n_res, n_gobs), np.nan)
        g_time = np.zeros((n_res, n_gobs))
        g_clim = np.zeros((n_res, 12))
        for slot, lk in gl_lakes.items():
            if lk not in gdata:
                continue
            v, tt, clim = gdata[lk]
            g_obs[slot, :v.size] = v
            g_time[slot, :tt.size] = tt
            g_clim[slot] = clim
        gl_fields = dict(gl_obs=_tensor(g_obs, dtype, device),
                         gl_obs_time=_tensor(g_time, dtype, device),
                         gl_climatology=_tensor(g_clim, dtype, device))

    base_da = ReservoirDAData.inactive(n_res, nts, device=device,
                                       dtype=dtype)
    months = pd.date_range(t0, periods=nts + 1,
                           freq=pd.Timedelta(seconds=dt)).month - 1
    def zeros():
        return torch.zeros(n_res, dtype=dtype, device=device)

    return base_da._replace(
        wbody_type=_tensor(wtypes, torch.int32, device),
        hybrid_obs=_tensor(obs, dtype, device),
        hybrid_obs_time=_tensor(obs_time, dtype, device),
        hybrid_state0=HybridDAState(
            persisted_outflow=torch.full((n_res,), float("nan"), dtype=dtype,
                                         device=device),
            update_time=zeros(), persistence_index=zeros(),
            persistence_update_time=zeros()),
        month_idx=_tensor(months, torch.int32, "cpu"),
        **rfc_fields, **gl_fields)


def _configure_logging(cfg, base, writer: bool = True):
    """Apply ``log_parameters`` (reference ``log_level_set``,
    nwm_routing/log_level_set.py:6-46): root level from ``log_level``,
    optional file handler + pre-run parameter dump under
    ``log_directory`` (by the ``writer`` rank only)."""
    lp = cfg.log_parameters
    level = getattr(logging, str(lp.log_level or "DEBUG").upper(),
                    logging.DEBUG)
    # level applies to this package's loggers; the root logger is only
    # touched when a log file is requested (keeps library use quiet)
    logging.getLogger("troute_torch").setLevel(level)
    log_dir = getattr(lp, "log_directory", None)
    if not log_dir or not writer:
        return
    log_dir = base / str(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(log_dir / "troute_torch.log")
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    logging.getLogger().addHandler(handler)
    # pre-run parameter dump (reference compute_log_mc "kernelTalks.log",
    # compute.py:298-506)
    cp = cfg.compute_parameters
    with open(log_dir / "kernelTalks.log", "w") as f:
        f.write("troute_torch pre-run parameters\n")
        f.write(f"compute_kernel: {cp.compute_kernel}\n")
        f.write(f"parallel_compute_method: {cp.parallel_compute_method}\n")
        f.write(f"assume_short_ts: {cp.assume_short_ts}\n")
        f.write(f"return_courant: {cp.return_courant}\n")
        fp = cp.forcing_parameters
        f.write(f"dt: {fp.dt}\nnts: {fp.nts}\n"
                f"qts_subdivisions: {fp.qts_subdivisions}\n")
        hp = cp.hybrid_parameters
        f.write(f"run_hybrid_routing: {hp.run_hybrid_routing}\n")
        f.write(f"run_refactored_network: {hp.run_refactored_network}\n")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="troute_torch")
    parser.add_argument("-f", "--custom-input-file", dest="config",
                        required=True)
    parser.add_argument("-V4", "--v4", action="store_true", default=True,
                        help="v4 config schema (default)")
    parser.add_argument("-V3", "--v3", action="store_true",
                        help="accept a v3-era YAML (the permissive schema "
                             "reads v3 keys; reference test_AnA.yaml runs "
                             "unmodified)")
    parser.add_argument("--cpu", action="store_true",
                        help="route on the CPU (the default is the first "
                             "CUDA device; without one the run fails)")
    parser.add_argument("-a", "--async-io", action="store_true",
                        help="overlap run-set forcing reads with routing "
                             "(see forcing_parameters.async_prefetch)")
    return parser


def _device(args) -> torch.device:
    """``--cpu``, else this process's CUDA device: the one ``torchrun``
    gives it (``LOCAL_RANK``) or the current one."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --cpu to route "
                           "on the CPU")
    if "LOCAL_RANK" in os.environ and not dist.is_initialized():
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", torch.cuda.current_device())


def _process_group(device):
    """(group, made here): the caller's default group when one exists,
    else the group ``torchrun``'s environment describes (``WORLD_SIZE``
    set), made here on ``device`` (NCCL on the card, gloo on the CPU; a
    group that cannot start raises); else (None, False), one process."""
    if dist.is_initialized():
        return dist.group.WORLD, False
    if "WORLD_SIZE" not in os.environ:
        return None, False
    from troute_torch.parallel.group import init_group
    return init_group(device), True


def main_v04(argv=None) -> dict:
    """Run a full simulation; returns a results dict of NumPy arrays (also
    used by tests).

    Under a process group (the caller's, or the one ``torchrun``'s
    environment describes, made here and destroyed at the end)
    ``parallel_compute_method: sharded`` routes across the group's ranks,
    one shard each, where the JAX command line shards across devices;
    every rank returns the same result and rank 0 alone writes files."""
    args = _parser().parse_args(argv)
    device = _device(args)
    group, own_group = _process_group(device)
    try:
        return _run(args, device, group)
    finally:
        if own_group:
            dist.destroy_process_group()


def _run(args, device, group) -> dict:
    """``main_v04``'s run in ``group`` (None: one process) on ``device``."""
    from troute_torch.config import load_config
    from troute_torch.io.forcing import read_qlat_chrtout
    from troute_torch.io.output import (
        write_chanobs_nc, write_flowveldepth_csv, write_lakeout_nc,
        write_lastobs_nc)
    from troute_torch.network.builder import build_network
    from troute_torch.ops.levelpool import LevelpoolParams
    from troute_torch.routing.engine import (
        ChannelParams, RoutingConfig, da_handoff,
        network_arrays_from_topology, route, route_stepped)

    world = 1 if group is None else dist.get_world_size(group)
    # rank 0 alone writes files (outputs, restarts, logs)
    writer = group is None or dist.get_rank(group) == 0

    task_times = {"network_time": 0.0, "forcing_time": 0.0,
                  "route_time": 0.0, "output_time": 0.0}
    main_start = time.time()

    base = Path(args.config).parent
    # -V3 engages reference-exact v3 key normalization; without it, v3
    # keys still map but with a logged warning (schema.load_config)
    cfg = load_config(args.config, v3=True if args.v3 else None)
    _configure_logging(cfg, base, writer)
    fp = cfg.compute_parameters.forcing_parameters
    if args.async_io:
        fp.async_prefetch = True
    rp = cfg.compute_parameters.restart_parameters
    dt = float(fp.dt)
    qts = int(fp.qts_subdivisions)
    nts = int(fp.nts or 0)
    if rp.start_datetime:
        s = str(rp.start_datetime).replace("_", " ")
        t0 = pd.to_datetime(s)
    else:
        t0 = pd.Timestamp("2000-01-01")

    # ---- network construction ----
    t_start = time.time()
    comp = cfg.compute_parameters
    strict_iterative = bool(getattr(comp, "strict_iterative", False))
    # the JAX command line shards short and fixed-point runs without
    # Courant numbers over its devices (troute_tpu/cli.py:680-707); here
    # over the ranks of the process group, and with one rank on one device
    shard = (str(comp.parallel_compute_method or "") == "sharded"
             and (comp.assume_short_ts or strict_iterative)
             and not comp.return_courant and world > 1)
    part = None
    hyb = None
    exclude = None
    hp = comp.hybrid_parameters
    if hp.run_hybrid_routing and hp.diffusive_domain:
        from troute_torch.routing.hybrid import HybridDomain
        hyb = HybridDomain(cfg, base)
        exclude = hyb.mainstem_set
        LOG.info("hybrid routing: %d mainstem segments in %d reaches",
                 len(hyb.mainstem_set), hyb.n_reaches)
        if hp.run_refactored_network and hp.refactored_domain \
                and hp.refactored_topobathy_domain:
            n_r = hyb.load_refactored(base / hp.refactored_domain,
                                      base / hp.refactored_topobathy_domain)
            LOG.info("refactored diffusive network: %d reaches", n_r)
        elif hp.use_natl_xsections and hp.topobathy_domain:
            n_nat = hyb.load_topobathy(base / hp.topobathy_domain)
            LOG.info("natural cross sections at %d nodes", n_nat)
        coastal_nc = fp.coastal_boundary_input_file
        if hp.coastal_boundary_domain and coastal_nc:
            nc_p = base / coastal_nc
            dom_p = base / hp.coastal_boundary_domain
            if nc_p.exists() and dom_p.exists():
                ok = hyb.load_coastal_boundary(nc_p, dom_p, t0)
                LOG.info("coastal downstream boundary: %s",
                         "active (dsbc_option=1)" if ok
                         else "no covered tailwater, using normal depth")
            else:
                LOG.warning("coastal boundary files missing (%s, %s); "
                            "falling back to normal-depth boundary",
                            nc_p, dom_p)
    built = build_network(cfg, base, exclude_ids=exclude)
    pp = cfg.network_topology_parameters.preprocessing_parameters
    if pp and pp.preprocess_only:
        # build + cache the network, then stop (reference
        # preprocess.py:509-533 early exit)
        LOG.info("preprocess_only: network cached, exiting")
        return {"fvd": np.zeros((0, built.n_nodes, 3)),
                "ids": np.asarray(built.topo.ids), "built": built,
                "task_times": task_times, "written": [], "parity": None,
                "courant": None, "diffusive": None, "final_state": None}
    topo = built.topo
    # the level-scan strict form needs the wavefront schedule; short-ts
    # and the fixed-point strict form don't
    level_scan = not comp.assume_short_ts and not strict_iterative
    net = network_arrays_from_topology(topo, device=device,
                                       need_levels=level_scan)
    dtype = torch.float32
    cp = ChannelParams.from_arrays(device=device, dtype=dtype, **built.chan)
    lp = LevelpoolParams.from_array(built.res_params, device=device,
                                    dtype=dtype)
    task_times["network_time"] = time.time() - t_start
    LOG.info("network: %d nodes, %d waterbodies, %d gages (%.1fs)",
             built.n_nodes, topo.reservoir_rows.size, built.gage_rows.size,
             task_times["network_time"])

    # ---- forcing run sets ----
    t_start = time.time()
    nexus_mode = built.nexus_of_wb is not None and bool(
        fp.nexus_input_folder or fp.qlat_input_folder)
    explicit_sets = getattr(fp, "qlat_forcing_sets", None)
    # no forcing folder at all -> single-CSV / constant qlat fallback
    # (reference NHDNetwork.build_qlateral_array, NHDNetwork.py:388-397)
    fileless_mode = (not explicit_sets and not fp.qlat_input_folder
                     and not fp.nexus_input_folder)
    if fileless_mode:
        nexus_mode = False
        run_sets = [{"qlat_files": [], "nts": int(nts or qts)}]
        task_times["forcing_time"] += time.time() - t_start
    elif explicit_sets:
        # pre-listed run sets (reference AbstractNetwork.py:747: the
        # forcing_parameters may enumerate qlat_files/nts per set)
        src_folder = fp.qlat_input_folder or fp.nexus_input_folder
        folder = base / src_folder if src_folder else base
        run_sets = [{"qlat_files": [folder / Path(f).name
                                    for f in s["qlat_files"]],
                     "nts": int(s.get("nts",
                                      len(s["qlat_files"]) * qts))}
                    for s in explicit_sets]
        task_times["forcing_time"] += time.time() - t_start
    elif nexus_mode:
        qlat_folder = base / (fp.nexus_input_folder or fp.qlat_input_folder)
        nex_pattern = getattr(fp, "nexus_file_pattern_filter",
                              None) or "*NEXOUT*"
        pattern = str(nex_pattern).strip("*")
    else:
        qlat_folder = base / fp.qlat_input_folder
        pattern = (fp.qlat_file_pattern_filter or "*CHRTOUT_DOMAIN1").strip("*")
    if not explicit_sets and not fileless_mode:
        files = sorted(f for f in qlat_folder.iterdir()
                       if pattern in f.name)
        # the reference derives the file list FROM t0 (filenames at
        # t0 + n*dt_qlat, AbstractNetwork.py:856-869) — a folder may hold
        # earlier hours (e.g. when resuming mid-folder from a restart);
        # drop files stamped before the start time
        if rp.start_datetime and files:
            in_window = [f for f in files if _file_stamp(f) is None
                         or _file_stamp(f) >= t0]
            if in_window and len(in_window) < len(files):
                LOG.info("forcing window: %d/%d files at or after %s",
                         len(in_window), len(files), t0)
                files = in_window
        run_sets = build_forcing_sets(files, dt, qts, nts,
                                      fp.max_loop_size)
        task_times["forcing_time"] += time.time() - t_start

    # ---- data assimilation ----
    total_nts = sum(r["nts"] for r in run_sets)
    da = assemble_gage_da(cfg, built, base, t0, total_nts, dt, dtype, device)
    res_da = assemble_reservoir_da(cfg, built, base, t0, total_nts, dt,
                                   dtype, device)
    if res_da is not None:
        n_hyb = int((res_da.wbody_type > 1).sum())
        LOG.info("reservoir DA: %d hybrid-persistence reservoirs", n_hyb)

    # ---- run-set loop with warm-state hand-off ----
    q0 = _tensor(built.q0, dtype, device)
    d0 = _tensor(built.depth0, dtype, device)
    elev0 = _tensor(built.res_elev0, dtype, device)
    all_fvd = []
    all_nudge = []
    all_courant = []
    op = cfg.output_parameters
    written = []
    step_offset = 0
    def read_forcing(run):
        if not run["qlat_files"]:
            # qlat_input_file CSV or qlat_const constant (reference
            # NHDNetwork.py:388-397); short CSVs repeat their last row,
            # matching the engine's hold-last-forcing semantics
            n_rows = max(1, -(-run["nts"] // qts))
            if fp.qlat_input_file:
                from troute_torch.io.forcing import read_qlat_csv
                ql = read_qlat_csv(base / fp.qlat_input_file, topo.ids)
                if ql.shape[0] < n_rows:
                    ql = np.concatenate(
                        [ql, np.repeat(ql[-1:], n_rows - ql.shape[0], 0)])
                return ql[:n_rows]
            return np.full((n_rows, topo.ids.size),
                           float(fp.qlat_const), np.float32)
        if nexus_mode:
            from troute_torch.network.hyfeatures import read_qlat_nexout
            binary_dir = getattr(fp, "binary_nexus_file_folder", None)
            return read_qlat_nexout(run["qlat_files"], topo.ids,
                                    built.nexus_of_wb,
                                    binary_folder=(base / str(binary_dir)
                                                   if binary_dir else None))
        return read_qlat_chrtout(
            run["qlat_files"], topo.ids,
            index_col=fp.qlat_file_index_col,
            value_col=fp.qlat_file_value_col,
            gw_bucket_col=fp.qlat_file_gw_bucket_flux_col,
            runoff_col=fp.qlat_file_terrain_runoff_col)

    # async IO: read the NEXT run set's forcing on a worker thread while
    # the current set routes — the pipelining the reference's
    # main_v03_async did with asyncio executors (__main__.py:1995-2115)
    prefetch_pool = None
    next_forcing = None
    if getattr(fp, "async_prefetch", False) and len(run_sets) > 1:
        from concurrent.futures import ThreadPoolExecutor
        prefetch_pool = ThreadPoolExecutor(max_workers=1)

    for s, run in enumerate(run_sets):
        t_start = time.time()
        if next_forcing is not None:
            ql = next_forcing.result()
        else:
            ql = read_forcing(run)
        if prefetch_pool is not None and s + 1 < len(run_sets):
            next_forcing = prefetch_pool.submit(read_forcing,
                                                run_sets[s + 1])
        else:
            next_forcing = None
        task_times["forcing_time"] += time.time() - t_start

        t_start = time.time()
        # compute_kernel ("auto", "pallas", "tpu", "xla", ...) selects
        # nothing here: short and fixed-point steps take route_stepped,
        # the level scan route()
        rcfg = RoutingConfig(
            dt=dt, nts=run["nts"], qts_subdivisions=qts,
            assume_short_ts=comp.assume_short_ts,
            return_courant=comp.return_courant,
            strict_iterative=strict_iterative,
            strict_sweep_chunk=int(getattr(comp, "strict_sweep_chunk", 16)),
            strict_accel=getattr(comp, "strict_accel", "auto"),
            strict_accel_lin=int(getattr(comp, "strict_accel_lin", 8)),
            strict_accel_chunk=int(getattr(comp, "strict_accel_chunk", 8)),
            strict_block_skip=getattr(comp, "strict_block_skip", "auto"))
        if shard:
            from troute_torch.parallel.sharded_engine import (
                route_sharded_global)
            if part is None:
                from troute_torch.parallel.partition import (
                    balanced_assignment, partition_network)
                t_part = time.time()
                part = partition_network(topo, world,
                                         balanced_assignment(topo, world))
                LOG.info("sharded routing: %d devices, %d nodes/device, %d "
                         "cut edges, %d exchange rounds (partition %.2fs)",
                         world, part.n_local, part.cut_edges,
                         part.perm_pairs.shape[0], time.time() - t_part)
            out = route_sharded_global(
                group, topo, built.chan, built.res_params, rcfg, q0, d0,
                elev0, ql, da=da, res_da=res_da, part=part,
                dtype=dtype, device=device)
        else:
            out = (route if level_scan else route_stepped)(
                net, cp, lp, rcfg, q0, d0, elev0, _tensor(ql, dtype, device),
                da, res_da)
        state = out["state"]
        q0, d0, elev0 = state.q, state.depth, state.res_elev
        set_seconds = run["nts"] * dt
        # the next run set's DA inputs: observations from its start, DA
        # state handed on with its clocks re-based to that start
        da, res_da = da_handoff(da, res_da, state, run["nts"], set_seconds)
        all_fvd.append(_host(out["flowveldepth"]))
        if out.get("nudge") is not None and out["nudge"].numel():
            all_nudge.append(_host(out["nudge"]))
        # lite restart at each run-set boundary (reference __main__.py:270)
        if writer and op.lite_restart \
                and op.lite_restart.get("lite_restart_output_directory") \
                and s < len(run_sets) - 1:
            from troute_torch.io.restart import write_lite_restart
            lr_dir = base / op.lite_restart["lite_restart_output_directory"]
            lr_dir.mkdir(parents=True, exist_ok=True)
            set_end = t0 + pd.Timedelta(
                seconds=(step_offset + run["nts"]) * dt)
            # reference new_q0 (AbstractNetwork.py:177-190) fills qu0 and
            # qd0 from the same final-flow column, so the restart carries
            # qu0 == qd0 — match that, not zeros
            q0_h = _host(q0)
            lr_q0 = pd.DataFrame(
                {"qu0": q0_h, "qd0": q0_h, "h0": _host(d0)},
                index=np.asarray(topo.ids))
            lr_wb = None
            if topo.reservoir_rows.size:
                lr_wb = pd.DataFrame(
                    {"qd0": q0_h[topo.reservoir_rows],
                     "h0": _host(elev0)[:topo.reservoir_rows.size]},
                    index=np.asarray(topo.ids)[topo.reservoir_rows])
            written.extend(write_lite_restart(lr_dir, set_end, lr_q0,
                                              lr_wb))
        # per-set lastobs (reference passes lastobs_df into the output
        # generator each run set, __main__.py:319)
        lastobs_dir_set = (cfg.compute_parameters
                           .data_assimilation_parameters.streamflow_da
                           .lastobs_output_folder
                           if cfg.compute_parameters
                           .data_assimilation_parameters.streamflow_da
                           else None)
        if writer and da is not None and lastobs_dir_set \
                and s < len(run_sets) - 1:
            from troute_torch.io.output import write_lastobs_nc
            lo_dir = base / lastobs_dir_set
            lo_dir.mkdir(parents=True, exist_ok=True)
            set_end = t0 + pd.Timedelta(
                seconds=(step_offset + run["nts"]) * dt)
            p = lo_dir / ("nudgingLastObs."
                          + set_end.strftime("%Y-%m-%d_%H:%M:%S") + ".nc")
            # the file is stamped at the set's end, where the handed-on
            # offsets start
            written.append(write_lastobs_nc(
                p, built.gage_ids, _host(da.lastobs_time),
                _host(da.lastobs_val), set_end))
        if comp.return_courant and out.get("courant") is not None:
            all_courant.append(_host(out["courant"]))
        task_times["route_time"] += time.time() - t_start
        step_offset += run["nts"]
        LOG.info("run set %d/%d: %d steps (%.1fs)", s + 1, len(run_sets),
                 run["nts"], task_times["route_time"])

    if prefetch_pool is not None:
        prefetch_pool.shutdown(wait=False)

    fvd = np.concatenate(all_fvd) if all_fvd else np.zeros((0, built.n_nodes, 3))
    out_ids = np.asarray(topo.ids).copy()
    # waterbody rows are reported under their OUTLET link id (reference
    # _reindex_lake_to_link_id, output.py:255-256) so link-keyed outputs
    # (CHRTOUT/HYDRO_RST appends, parity) resolve them
    if built.lake_crosswalk:
        from troute_torch.network.builder import positions_of
        lakes = np.fromiter(built.lake_crosswalk, np.int64,
                            len(built.lake_crosswalk))
        outlets = np.fromiter(built.lake_crosswalk.values(), np.int64,
                              lakes.size)
        at, is_lake = positions_of(lakes, out_ids)
        out_ids[is_lake] = outlets[at[is_lake]]

    # ---- diffusive mainstem routing (hybrid coupling) ----
    diffusive_out = None
    if hyb is not None and fvd.shape[0]:
        from troute_torch.routing.hybrid import run_mainstem
        all_files = [f for r in run_sets for f in r["qlat_files"]]
        if all_files:
            qlat_source = all_files
        elif fp.qlat_input_file:
            qlat_source = base / fp.qlat_input_file
        else:
            qlat_source = float(fp.qlat_const)
        ms = run_mainstem(
            hyb, fvd, topo.ids, built.q0, qlat_source, dt, qts, hp, device,
            out_ids=out_ids, group=group if shard else None,
            n_qlat_rows=sum(max(1, -(-r["nts"] // qts)) for r in run_sets))
        fvd, out_ids, diffusive_out = ms["fvd"], ms["ids"], ms["diffusive"]
        task_times["route_time"] += ms["seconds"]

    # ---- outputs ----
    t_start = time.time()
    def _subset(segments):
        """Restrict (ids, fvd) to requested segment ids (reference
        csv_output_segments / parquet_output_segments, output.py:198)."""
        if not segments:
            return out_ids, fvd
        keep = np.isin(out_ids, np.asarray(segments, np.int64))
        return out_ids[keep], fvd[:, keep]

    if writer and op.csv_output and op.csv_output.get("csv_output_folder"):
        out_dir = base / op.csv_output["csv_output_folder"]
        out_dir.mkdir(parents=True, exist_ok=True)
        p = out_dir / f"flowveldepth_{t0.strftime('%Y%m%d%H%M')}.csv"
        sub_ids, sub_fvd = _subset(op.csv_output.get("csv_output_segments"))
        written.append(write_flowveldepth_csv(p, sub_ids, sub_fvd, t0, dt))
        if all_courant:
            # reference writes courant_*.csv beside the fvd csv when
            # return_courant is on (output.py:452-470)
            cour = np.concatenate(all_courant)
            cdf = pd.DataFrame(
                cour.transpose(1, 0, 2).reshape(cour.shape[1], -1),
                # same row keys as the fvd csv: waterbody rows under
                # their outlet link id
                index=out_ids[:cour.shape[1]],
                columns=[(t, v) for t in range(cour.shape[0])
                         for v in ("cn", "ck", "X")])
            pc = out_dir / f"courant_{t0.strftime('%Y%m%d%H%M')}.csv"
            cdf.to_csv(pc)
            written.append(pc)
    if writer and op.test_output:
        # pickle of the full flowveldepth DataFrame in the reference's
        # test frame shape: index = segment ids (lakes under outlet link
        # ids), flat (timestep, 'q'|'v'|'d') tuple columns
        # (output.py:320-322, qvd_columns :209-211)
        tp = base / op.test_output
        tp.parent.mkdir(parents=True, exist_ok=True)
        tdf = pd.DataFrame(
            fvd.transpose(1, 0, 2).reshape(fvd.shape[1], -1),
            index=out_ids,
            columns=[(t, v) for t in range(fvd.shape[0])
                     for v in ("q", "v", "d")])
        tdf.to_pickle(tp)
        written.append(tp)
    if writer and op.stream_output \
            and op.stream_output.stream_output_directory:
        import yaml as _yaml

        from troute_torch.io.output import write_stream_output
        so = op.stream_output
        mask_list = None
        mask_path = getattr(so, "mask_output", None)
        if mask_path and (base / str(mask_path)).exists():
            with open(base / str(mask_path)) as f:
                mask_list = _yaml.safe_load(f)
        nexus_members = None
        if built.wb_downstream_nexus:
            nexus_members = {}
            for wb, nx in built.wb_downstream_nexus.items():
                nexus_members.setdefault(int(nx), []).append(int(wb))
        nudge_arr = np.concatenate(all_nudge) if all_nudge else None
        written.extend(write_stream_output(
            base / so.stream_output_directory, out_ids, fvd, t0, dt,
            nudge=nudge_arr,
            nudge_ids=(topo.ids[built.gage_rows]
                       if built.gage_rows.size else None),
            output_type=so.stream_output_type or ".nc",
            file_hours=float(so.stream_output_time or 1.0),
            internal_frequency_min=so.stream_output_internal_frequency,
            mask_list=mask_list, nexus_members=nexus_members))
    if writer and op.chanobs_output \
            and op.chanobs_output.chanobs_output_directory \
            and built.gage_rows.size:
        out_dir = base / op.chanobs_output.chanobs_output_directory
        out_dir.mkdir(parents=True, exist_ok=True)
        # a configured chanobs_filepath is a FIXED file that consecutive
        # forecast cycles append to (reference output.py:529-542 +
        # nhd_io.write_chanobs create-or-append); otherwise one fresh
        # timestamped file per run
        if op.chanobs_output.chanobs_filepath:
            p = out_dir / op.chanobs_output.chanobs_filepath
            append = True
        else:
            p = out_dir / f"chanobs_{t0.strftime('%Y%m%d%H%M')}.nc"
            append = False
        written.append(write_chanobs_nc(
            p, built.gage_ids, topo.ids[built.gage_rows],
            fvd[:, built.gage_rows], t0, dt, append=append))
    if writer and op.parquet_output \
            and op.parquet_output.get("parquet_output_folder"):
        from troute_torch.io.output import flowveldepth_dataframe
        out_dir = base / op.parquet_output["parquet_output_folder"]
        out_dir.mkdir(parents=True, exist_ok=True)
        sub_ids, sub_fvd = _subset(
            op.parquet_output.get("parquet_output_segments"))
        df = flowveldepth_dataframe(sub_ids, sub_fvd, t0, dt)
        df.columns = [f"{ts.isoformat()}_{v}" for ts, v in df.columns]
        p = out_dir / f"troute_output_{t0.strftime('%Y%m%d%H%M')}.parquet"
        df.to_parquet(p)
        written.append(p)
    if writer and op.lite_restart \
            and op.lite_restart.get("lite_restart_output_directory"):
        from troute_torch.io.restart import write_lite_restart
        out_dir = base / op.lite_restart["lite_restart_output_directory"]
        out_dir.mkdir(parents=True, exist_ok=True)
        end_time = t0 + pd.Timedelta(seconds=total_nts * dt)
        # qu0 == qd0 per reference new_q0 (AbstractNetwork.py:177-190)
        q0_h = _host(q0)
        q0_df = pd.DataFrame(
            {"qu0": q0_h, "qd0": q0_h, "h0": _host(d0)},
            index=np.asarray(topo.ids))
        wb_df = None
        if topo.reservoir_rows.size:
            wb_df = pd.DataFrame(
                {"qd0": q0_h[topo.reservoir_rows],
                 "h0": _host(elev0)[:topo.reservoir_rows.size]},
                index=np.asarray(topo.ids)[topo.reservoir_rows])
        written.extend(write_lite_restart(out_dir, end_time, q0_df, wb_df))
    lastobs_dir = (cfg.compute_parameters.data_assimilation_parameters
                   .streamflow_da.lastobs_output_folder
                   if cfg.compute_parameters.data_assimilation_parameters
                   .streamflow_da else None) or op.lastobs_output
    if writer and da is not None and lastobs_dir:
        from troute_torch.io.output import write_lastobs_nc
        out_dir = base / lastobs_dir
        out_dir.mkdir(parents=True, exist_ok=True)
        end_time = t0 + pd.Timedelta(seconds=total_nts * dt)
        p = out_dir / ("nudgingLastObs."
                       + end_time.strftime("%Y-%m-%d_%H:%M:%S") + ".nc")
        written.append(write_lastobs_nc(
            p, built.gage_ids, _host(da.lastobs_time),
            _host(da.lastobs_val), end_time))
    chrto = op.chrtout_output
    if writer and chrto and chrto.wrf_hydro_channel_output_source_folder:
        from troute_torch.io.output import append_chrtout
        src = base / chrto.wrf_hydro_channel_output_source_folder
        files = [src / Path(f).name
                 for r in run_sets for f in r["qlat_files"]]
        files = [f for f in files if f.exists()]
        written.extend(append_chrtout(files, out_ids, fvd, qts))
    rsrto = op.wrf_hydro_restart_output or {}
    rst_src = (rsrto.get("wrf_hydro_channel_restart_source_directory")
               or rsrto.get("wrf_hydro_restart_dir"))
    if writer and rst_src:
        from troute_torch.io.restart import append_hydro_rst
        src = base / rst_src
        patt = rsrto.get("wrf_hydro_channel_restart_pattern_filter",
                         "HYDRO_RST.*")
        xwalk = rsrto.get("wrf_hydro_channel_ID_crosswalk_file") \
            or rp.wrf_hydro_channel_ID_crosswalk_file
        if xwalk:
            written.extend(append_hydro_rst(
                sorted(src.glob(patt)), out_ids, fvd, t0, dt,
                base / xwalk))
    if writer and op.lakeout_output and topo.reservoir_rows.size \
            and fvd.shape[0]:
        # one lakeout file per output hour (reference writes waterbody
        # states each qts-th step, output.py:231-258 + nhd_io:1775)
        out_dir = base / str(op.lakeout_output)
        out_dir.mkdir(parents=True, exist_ok=True)
        res_rows = topo.reservoir_rows
        up = topo.upstream[res_rows]             # [n_res, K]
        for step in range(qts - 1, fvd.shape[0], qts):
            prev_q = (fvd[step - 1, :, 0] if step > 0
                      else np.asarray(built.q0))
            vals = prev_q[np.maximum(up, 0)]
            inflow = np.where(up >= 0, vals, 0.0).sum(axis=1)
            stamp = t0 + pd.Timedelta(seconds=(step + 1) * dt)
            p = out_dir / f"{stamp.strftime('%Y%m%d%H%M')}.LAKEOUT.nc"
            written.append(write_lakeout_nc(
                p, topo.ids[res_rows], fvd[step, res_rows, 0],
                fvd[step, res_rows, 2], inflow, stamp))
    # config-driven WRF-Hydro parity check (reference
    # build_tests.parity_check, build_tests.py:163-301)
    parity_stats = None
    pc = op.wrf_hydro_parity_check or {}
    if pc.get("parity_check_input_folder") \
            and pc.get("parity_check_compare_node"):
        from troute_torch.parity import parity_check, read_chrtout_streamflow
        node = int(pc["parity_check_compare_node"])
        patt = pc.get("parity_check_file_pattern_filter",
                      "*CHRTOUT_DOMAIN1")
        vfiles = sorted((base / pc["parity_check_input_folder"]).rglob(patt))
        vfiles = [f for f in vfiles
                  if t0 < pd.to_datetime(f.name.split(".")[0],
                                         format="%Y%m%d%H%M")
                  <= t0 + pd.Timedelta(seconds=fvd.shape[0] * dt)]
        row = {int(s): k for k, s in enumerate(out_ids)}.get(node)
        if vfiles and row is not None:
            ref_q = read_chrtout_streamflow(vfiles, [node])[:, 0]
            stamps = [pd.to_datetime(f.name.split(".")[0],
                                     format="%Y%m%d%H%M") for f in vfiles]
            steps = [int(round((s - t0).total_seconds() / dt)) - 1
                     for s in stamps]
            sim_q = fvd[np.asarray(steps), row, 0]
            parity_stats = parity_check(sim_q[:, None], ref_q[:, None],
                                        label=f"node {node}")
            LOG.info("parity check at node %d: %s", node, parity_stats)
    task_times["output_time"] = time.time() - t_start

    task_times["total_time"] = time.time() - main_start
    if writer and cfg.log_parameters.showtiming:
        tt = task_times
        print("troute_torch timing summary")
        print(f"  network build : {tt['network_time']:.2f} s")
        print(f"  forcing       : {tt['forcing_time']:.2f} s")
        print(f"  routing       : {tt['route_time']:.2f} s")
        print(f"  output        : {tt['output_time']:.2f} s")
        print(f"  total         : {tt['total_time']:.2f} s")

    return {"fvd": fvd, "ids": out_ids, "built": built,
            "task_times": task_times, "written": written,
            "parity": parity_stats,
            "courant": (np.concatenate(all_courant)
                        if all_courant else None),
            "diffusive": diffusive_out,
            "final_state": (_host(q0), _host(d0), _host(elev0))}


async def main_v03_async(argv=None) -> dict:
    """Async-pipelined simulation entry point.

    Mirrors the intent of the reference's ``main_v03_async``
    (``__main__.py:1892-2195``): run-set forcing reads execute on worker
    threads overlapped with routing.  (In the reference the async
    dispatch is commented out, ``__main__.py:2211-2217``; here it is
    live.)  Accepts the same configs as ``main_v04`` and returns its
    results dict.
    """
    import asyncio

    loop = asyncio.get_running_loop()
    argv = list(argv or [])
    if "-a" not in argv and "--async-io" not in argv:
        argv.append("--async-io")
    return await loop.run_in_executor(None, lambda: main_v04(argv))

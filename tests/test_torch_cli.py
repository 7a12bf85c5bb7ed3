"""The port's command line (``troute_torch.cli.main_v04``) against the JAX
package's (``troute_tpu.cli.main_v04``), both with ``--cpu``, on the same
control files over synthetic domains made from a seed (600-800 segments, a
handful of lakes and gages, 2-3 run sets).

Exact: ids, shapes, the names of the written files, their time stamps and
integer or string variables, the keys of ``task_times`` and of the result.

Tolerance on ``fvd`` and on every written flow, velocity and depth, the f32
bar: relative difference (against max(|reference|, 1e-6)) median <= 1e-6,
p95 <= 1e-5, max <= 5e-2.  Both sides compute in float32 with different
``pow`` implementations (XLA's and PyTorch's), whose last-bit differences a
few secant lanes amplify.  The JAX command line on the CPU routes through
``route()`` and the port through ``route_stepped``, which
``tests/test_stepped.py`` pins equal in the JAX package.  The strict
fixed-point mode stops on a tolerance, so there at most 1e-3 of the values
may lie past rtol/atol 1e-4, besides the bar.  The written nudge (an
observation minus a model flow) is a difference and is held to rtol/atol
1e-5, the flows' absolute accuracy.
"""

import copy
from pathlib import Path

import h5py
import numpy as np
import pandas as pd
import pytest
import yaml

from test_torch_network import (geopackage_config, routelink_config,
                                write_geopackage_domain,
                                write_routelink_domain)
from troute_torch import cli as torch_cli
from troute_torch import synthetic
from troute_tpu import cli as jax_cli

T0 = pd.Timestamp("2021-08-23 13:00")
START = "2021-08-23_13:00"


def f32_bar(got, want, strict=False):
    """The f32 bar over the finite reference values; NaNs must coincide."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if not ok.any():
        return
    rel = np.abs(got[ok] - want[ok]) / np.maximum(np.abs(want[ok]), 1e-6)
    assert np.median(rel) <= 1e-6, np.median(rel)
    assert np.percentile(rel, 95) <= 1e-5, np.percentile(rel, 95)
    assert rel.max() <= 5e-2, rel.max()
    if strict:
        off = ~np.isclose(got[ok], want[ok], rtol=1e-4, atol=1e-4)
        assert off.sum() <= 1e-3 * off.size, int(off.sum())


def run_both(cfg, base_t, base_j, name="cfg.yaml", extra=()):
    """The same control file under two copies of one domain, through the
    port's and the JAX package's command line on the CPU."""
    out = []
    for cli, base in ((torch_cli, base_t), (jax_cli, base_j)):
        p = base / name
        yaml.safe_dump(cfg, open(p, "w"))
        out.append(cli.main_v04(["-f", str(p), "--cpu", *extra]))
    return out


def assert_results_match(got, want, strict=False):
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert got["ids"].dtype == want["ids"].dtype
    assert got["task_times"].keys() == want["task_times"].keys()
    assert isinstance(got["fvd"], np.ndarray)
    f32_bar(got["fvd"], want["fvd"], strict)
    assert got["fvd"].dtype == want["fvd"].dtype
    for g, w in zip(got["final_state"], want["final_state"]):
        assert isinstance(g, np.ndarray)
        f32_bar(g, w, strict)
    assert [p.name for p in got["written"]] == \
        [p.name for p in want["written"]]
    assert got["diffusive"] is None and want["diffusive"] is None


def assert_files_match(got_paths, want_paths, strict=False):
    """Written files pair by pair: NetCDF variable by variable (floats at
    the f32 bar, the rest exact), CSV, parquet and pickles as frames."""
    assert len(got_paths) == len(want_paths)
    for pg, pw in zip(got_paths, want_paths):
        assert pg.name == pw.name
        if pg.suffix in (".nc", ".ncdf"):
            with h5py.File(pg) as fg, h5py.File(pw) as fw:
                assert set(fg) == set(fw)
                for k in fw:
                    g, w = fg[k][...], fw[k][...]
                    assert g.dtype == w.dtype, (pg.name, k)
                    if k == "nudge":
                        # observation minus model flow: a difference, held
                        # to the flows' absolute accuracy (flows here are
                        # below 10, one f32 ulp of which is 1e-6)
                        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
                    elif w.dtype.kind == "f":
                        f32_bar(g, w, strict)
                    else:
                        np.testing.assert_array_equal(g, w, err_msg=k)
                for k in fw.attrs:
                    if k != "TITLE":
                        assert np.all(fg.attrs[k] == fw.attrs[k]), k
            continue
        if pg.suffix == ".csv":
            g, w = pd.read_csv(pg, index_col=0), pd.read_csv(pw, index_col=0)
        elif pg.suffix == ".parquet":
            g, w = pd.read_parquet(pg), pd.read_parquet(pw)
        else:
            g, w = pd.read_pickle(pg), pd.read_pickle(pw)
        assert list(g.index) == list(w.index), pg.name
        assert [str(c) for c in g.columns] == [str(c) for c in w.columns]
        f32_bar(g.to_numpy(np.float64), w.to_numpy(np.float64), strict)


# ---------------------------------------------------------------- (a)

def _chars(strings, width=15):
    return np.array([list(f"{s:<{width}}") for s in strings], "S1")


def _routelink_case(base, seed=0):
    """A RouteLink domain with CHRTOUT forcing for three hours, USGS
    TimeSlice files (the stream gages and one reservoir gage) and a
    reservoir index file that types the first lake as USGS persistence."""
    dom = write_routelink_domain(base, seed=seed)
    rng = np.random.default_rng(seed + 100)
    (base / "channel_forcing").mkdir()
    for k in range(3):
        stamp = (T0 + pd.Timedelta(hours=k)).strftime("%Y%m%d%H%M")
        with h5py.File(base / "channel_forcing"
                       / f"{stamp}.CHRTOUT_DOMAIN1", "w") as f:
            f["feature_id"] = dom["ids"]
            f["q_lateral"] = rng.uniform(0.0, 1.5, dom["ids"].size
                                         ).astype(np.float32)
    res_gage = "09999999"
    gages = list(dom["gage_ids"]) + [res_gage]
    (base / "usgs_TimeSlice").mkdir()
    for k in range(-4, 14):
        when = T0 + pd.Timedelta(minutes=15 * k)
        stamp = when.strftime("%Y-%m-%d_%H:%M:%S")
        q = rng.uniform(0.5, 8.0, len(gages))
        quality = np.full(len(gages), 100, np.int16)
        quality[rng.random(len(gages)) < 0.2] = 0
        with h5py.File(base / "usgs_TimeSlice"
                       / f"{stamp}.15min.usgsTimeSlice.ncdf", "w") as f:
            f["stationId"] = _chars(gages)
            f["time"] = _chars([stamp] * len(gages), 19)
            f["discharge"] = q.astype(np.float32)
            f["discharge_quality"] = quality
    lakes = dom["lake_ids"]
    with h5py.File(base / "domain" / "reservoir_index.nc", "w") as f:
        f["lake_id"] = lakes
        f["reservoir_type"] = np.array([2] + [1] * (lakes.size - 1),
                                       np.int32)
        f["usgs_lake_id"] = lakes[:1]
        f["usgs_gage_id"] = _chars([res_gage])
        f["usace_lake_id"] = np.zeros(0, np.int64)
        f["usace_gage_id"] = _chars([])
        f["rfc_lake_id"] = np.zeros(0, np.int64)
        f["rfc_gage_id"] = _chars([], 5)
    return dom


def _routelink_cfg(nts=36, reservoir_da=True, **restart):
    cfg = routelink_config(start_datetime=START, **restart)
    cfg["log_parameters"] = {"showtiming": False, "log_level": "INFO"}
    cfg["compute_parameters"].update(
        compute_kernel="V02-structured", assume_short_ts=True,
        forcing_parameters={
            "dt": 300, "qts_subdivisions": 12, "nts": nts,
            "max_loop_size": 1, "qlat_input_folder": "channel_forcing",
            "qlat_file_pattern_filter": "*.CHRTOUT_DOMAIN1"},
        data_assimilation_parameters={
            "usgs_timeslices_folder": "usgs_TimeSlice",
            "timeslice_lookback_hours": 24, "qc_threshold": 1,
            "interpolation_limit_min": 59,
            "streamflow_da": {"streamflow_nudging": True,
                              "lastobs_output_folder": "lastobs"},
            "reservoir_da": {
                "reservoir_persistence_da": {
                    "reservoir_persistence_usgs": reservoir_da,
                    "reservoir_persistence_usace": False},
                "reservoir_parameter_file": "domain/reservoir_index.nc"}})
    cfg["output_parameters"] = {
        "csv_output": {"csv_output_folder": "out"},
        "chanobs_output": {"chanobs_output_directory": "out"},
        "lakeout_output": "lakeout", "test_output": "out/test.pkl",
        "lite_restart": {"lite_restart_output_directory": "restart"},
        "stream_output": {"stream_output_directory": "stream",
                          "stream_output_type": ".nc",
                          "stream_output_time": 1,
                          "stream_output_internal_frequency": 30}}
    return cfg


@pytest.fixture(scope="module")
def routelink_runs(tmp_path_factory):
    bases = [tmp_path_factory.mktemp(k) for k in ("rl_torch", "rl_jax")]
    for base in bases:
        _routelink_case(base)
    got, want = run_both(_routelink_cfg(), *bases)
    return dict(got=got, want=want, bases=bases)


def test_routelink_run_sets_match(routelink_runs):
    got, want = routelink_runs["got"], routelink_runs["want"]
    assert_results_match(got, want)
    n = got["built"].n_nodes
    assert got["fvd"].shape == (36, n, 3) and np.isfinite(got["fvd"]).all()
    assert got["built"].topo.reservoir_rows.size == 4
    assert got["built"].gage_rows.size == 6
    assert set(got["task_times"]) == {"network_time", "forcing_time",
                                      "route_time", "output_time",
                                      "total_time"}
    # three run sets: two boundary restarts and lastobs files, one final
    names = [p.name for p in got["written"]]
    assert names.count("channel_restart_202108231400") == 1
    assert sum(n_.startswith("nudgingLastObs.") for n_ in names) == 3
    assert sum(n_.endswith(".LAKEOUT.nc") for n_ in names) == 3


def test_routelink_data_assimilation_engaged(routelink_runs):
    """Nudging and the USGS persistence reservoir change the flows, in
    both packages alike (so the comparison above covers them)."""
    bases = routelink_runs["bases"]
    cfg = _routelink_cfg(reservoir_da=False)
    cfg["compute_parameters"]["data_assimilation_parameters"][
        "streamflow_da"]["streamflow_nudging"] = False
    cfg["output_parameters"] = {}
    got, want = run_both(cfg, *bases, name="noda.yaml")
    assert_results_match(got, want)
    with_da = routelink_runs["got"]
    rows = with_da["built"].gage_rows
    assert not np.allclose(with_da["fvd"][:, rows, 0], got["fvd"][:, rows, 0])
    lake = with_da["built"].topo.reservoir_rows[0]
    assert not np.allclose(with_da["fvd"][:, lake, 0], got["fvd"][:, lake, 0])


def test_routelink_written_files_match(routelink_runs):
    got, want = routelink_runs["got"], routelink_runs["want"]
    assert_files_match(got["written"], want["written"])
    kinds = {p.name.split(".")[-1] for p in got["written"]}
    assert {"csv", "nc", "pkl"} <= kinds
    with h5py.File(next(p for p in got["written"]
                        if p.name.startswith("chanobs"))) as f:
        assert f["streamflow"].shape == (36, 6)
    # the lite restart written at the last boundary reads back as the state
    from troute_torch.io.restart import read_lite_restart
    df = read_lite_restart(routelink_runs["bases"][0] / "restart"
                           / "channel_restart_202108231600")
    np.testing.assert_array_equal(df.index, got["built"].topo.ids)
    np.testing.assert_array_equal(df["qd0"].to_numpy(np.float32),
                                  got["final_state"][0])


def test_routelink_restart_cycling_across_invocations(routelink_runs,
                                                      tmp_path_factory):
    """Invocation 2 warm-starts from the lite restart and lastobs files
    that invocation 1 wrote, mid-folder (reservoir persistence is
    cycle-local, so it is off): port against JAX package per invocation,
    and the port's 24 + 12 steps against its own 36 in one go."""
    bases = [tmp_path_factory.mktemp(k) for k in ("cyc_torch", "cyc_jax")]
    for base in bases:
        _routelink_case(base)
    cont = _routelink_cfg(reservoir_da=False)
    cont["output_parameters"] = {}
    cont_t, cont_j = run_both(cont, *bases, name="cont.yaml")
    assert_results_match(cont_t, cont_j)

    c1 = _routelink_cfg(nts=24, reservoir_da=False)
    c1["output_parameters"] = {
        "lite_restart": {"lite_restart_output_directory": "state"}}
    c1["compute_parameters"]["data_assimilation_parameters"][
        "streamflow_da"]["lastobs_output_folder"] = "state"
    r1_t, r1_j = run_both(c1, *bases, name="c1.yaml")
    assert_results_match(r1_t, r1_j)
    assert_files_match(r1_t["written"], r1_j["written"])
    assert r1_t["fvd"].shape[0] == 24

    c2 = _routelink_cfg(
        nts=12, reservoir_da=False,
        lite_channel_restart_file="state/channel_restart_202108231500",
        lite_waterbody_restart_file="state/waterbody_restart_202108231500")
    c2["compute_parameters"]["restart_parameters"]["start_datetime"] = \
        "2021-08-23_15:00"
    c2["compute_parameters"]["data_assimilation_parameters"][
        "streamflow_da"]["lastobs_file"] = \
        "state/nudgingLastObs.2021-08-23_15:00:00.nc"
    c2["output_parameters"] = {}
    r2_t, r2_j = run_both(c2, *bases, name="c2.yaml")
    assert_results_match(r2_t, r2_j)
    assert r2_t["fvd"].shape[0] == 12
    f32_bar(np.concatenate([r1_t["fvd"], r2_t["fvd"]]), cont_t["fvd"])


def test_async_prefetch_and_v3_flags_match(routelink_runs):
    """``-a`` (forcing read ahead on a thread) and ``-V3`` change no
    result; ``main_v03_async`` returns the same dict."""
    import asyncio
    base = routelink_runs["bases"][0]
    cfg = _routelink_cfg()
    cfg["output_parameters"] = {}
    p = base / "flags.yaml"
    yaml.safe_dump(cfg, open(p, "w"))
    plain = torch_cli.main_v04(["-f", str(p), "--cpu"])
    ahead = torch_cli.main_v04(["-f", str(p), "--cpu", "-a", "-V3"])
    np.testing.assert_array_equal(ahead["fvd"], plain["fvd"])
    np.testing.assert_array_equal(plain["fvd"], routelink_runs["got"]["fvd"])
    again = asyncio.run(torch_cli.main_v03_async(["-f", str(p), "--cpu"]))
    np.testing.assert_array_equal(again["fvd"], plain["fvd"])


# ---------------------------------------------------------------- (b)

def _geopackage_case(base, seed=1):
    dom = write_geopackage_domain(base, seed=seed)
    rng = np.random.default_rng(seed + 200)
    (base / "forcing").mkdir()
    for k in range(2):
        stamp = (T0 + pd.Timedelta(hours=k)).strftime("%Y%m%d%H%M")
        synthetic.write_nexout_csv(base / "forcing" / f"{stamp}NEXOUT.csv",
                                   dom["ids"],
                                   rng.uniform(0.01, 1.0, dom["ids"].size))
    return dom


def _geopackage_cfg(ids, **compute):
    cfg = geopackage_config()
    cfg["log_parameters"] = {"showtiming": True, "log_level": "INFO",
                             "log_directory": "logs"}
    cfg["compute_parameters"].update(
        compute_kernel="auto", assume_short_ts=True,
        restart_parameters={"start_datetime": START},
        forcing_parameters={
            "dt": 300, "qts_subdivisions": 12, "nts": 24,
            "max_loop_size": 1, "nexus_input_folder": "forcing",
            "qlat_input_folder": "forcing",
            "binary_nexus_file_folder": "forcing_bin"},
        data_assimilation_parameters={})
    cfg["compute_parameters"].update(compute)
    cfg["output_parameters"] = {
        "parquet_output": {"parquet_output_folder": "out",
                           "parquet_output_segments":
                               [int(i) for i in ids[::7]]},
        "csv_output": {"csv_output_folder": "out",
                       "csv_output_segments": [int(i) for i in ids[:9]]},
        "lite_restart": {"lite_restart_output_directory": "restart"}}
    return cfg


@pytest.fixture(scope="module")
def geopackage_bases(tmp_path_factory):
    bases = [tmp_path_factory.mktemp(k) for k in ("gp_torch", "gp_jax")]
    doms = [_geopackage_case(base) for base in bases]
    return bases, doms[0]


def test_geopackage_nexout_parquet_match(geopackage_bases, capsys):
    """The configuration that needs no HDF5: geopackage domain, NEXOUT CSV
    forcing, parquet and CSV subsets, lite restart, two run sets."""
    bases, dom = geopackage_bases
    got, want = run_both(_geopackage_cfg(dom["ids"]), *bases)
    assert "troute_torch timing summary" in capsys.readouterr().out
    assert_results_match(got, want)
    assert_files_match(got["written"], want["written"])
    assert got["fvd"].shape == (48 // 2, dom["ids"].size, 3)
    assert got["built"].topo.reservoir_rows.size == 5
    assert {p.suffix for p in got["written"]} == {".parquet", ".csv", ""}
    # lake rows are reported under their outlet flowpath's id
    lake_rows = got["built"].topo.reservoir_rows
    assert set(got["ids"][lake_rows]) == set(
        got["built"].lake_crosswalk.values())
    assert (bases[0] / "logs" / "kernelTalks.log").read_text().startswith(
        "troute_torch pre-run parameters")
    assert (bases[0] / "forcing_bin" / "nexout.parquet").exists()


@pytest.mark.parametrize("kernel", ["pallas", "tpu", "xla", "V02-structured"])
def test_compute_kernel_names_accepted(geopackage_bases, kernel):
    """Every ``compute_kernel`` the JAX command line knows routes through
    the port's one stepped engine, to the same numbers."""
    bases, dom = geopackage_bases
    cfg = _geopackage_cfg(dom["ids"], compute_kernel=kernel)
    cfg["output_parameters"] = {}
    cfg["compute_parameters"]["forcing_parameters"]["nts"] = 12
    p = bases[0] / f"kernel_{kernel}.yaml"
    yaml.safe_dump(cfg, open(p, "w"))
    got = torch_cli.main_v04(["-f", str(p), "--cpu"])
    auto = copy.deepcopy(cfg)
    auto["compute_parameters"]["compute_kernel"] = "auto"
    yaml.safe_dump(auto, open(p, "w"))
    want = torch_cli.main_v04(["-f", str(p), "--cpu"])
    np.testing.assert_array_equal(got["fvd"], want["fvd"])


# ---------------------------------------------------------------- (c)

@pytest.mark.parametrize("mode", ["qlat_const", "qlat_input_file",
                                  "explicit_sets"])
def test_other_forcing_sources_match(geopackage_bases, mode):
    bases, dom = geopackage_bases
    cfg = _geopackage_cfg(dom["ids"])
    cfg["output_parameters"] = {}
    fp = cfg["compute_parameters"]["forcing_parameters"]
    fp.pop("binary_nexus_file_folder")
    if mode == "explicit_sets":
        fp["qlat_forcing_sets"] = [
            {"qlat_files": ["202108231300NEXOUT.csv"], "nts": 12},
            {"qlat_files": ["202108231400NEXOUT.csv"]}]
    else:
        del fp["nexus_input_folder"], fp["qlat_input_folder"]
        fp["nts"] = 30
        if mode == "qlat_const":
            fp["qlat_const"] = 0.25
        else:
            rng = np.random.default_rng(5)
            for base in bases:
                pd.DataFrame(rng.uniform(0, 1, (dom["ids"].size - 4, 2)),
                             index=dom["ids"][4:]).to_csv(base / "ql.csv")
                rng = np.random.default_rng(5)
            fp["qlat_input_file"] = "ql.csv"
    got, want = run_both(cfg, *bases, name=f"{mode}.yaml")
    assert_results_match(got, want)
    assert got["fvd"].shape[0] == (24 if mode == "explicit_sets" else 30)
    assert (got["fvd"][-1, :, 0] > 0).mean() > 0.9


# ---------------------------------------------------------------- (d)

def test_strict_iterative_matches(geopackage_bases):
    """``strict_iterative: True`` (the fixed-point strict form), Courant
    numbers returned, from a routed state: the first run set is the warm-up
    that both packages share through the lite restart it writes."""
    bases, dom = geopackage_bases
    warm = _geopackage_cfg(dom["ids"])
    warm["compute_parameters"]["forcing_parameters"]["nts"] = 12
    warm["output_parameters"] = {
        "lite_restart": {"lite_restart_output_directory": "warm"}}
    run_both(warm, *bases, name="warm.yaml")
    cfg = _geopackage_cfg(
        dom["ids"], assume_short_ts=False, strict_iterative=True,
        return_courant=True,
        restart_parameters={
            "start_datetime": "2021-08-23_14:00",
            "lite_channel_restart_file":
                "warm/channel_restart_202108231400",
            "lite_waterbody_restart_file":
                "warm/waterbody_restart_202108231400"})
    cfg["compute_parameters"]["forcing_parameters"].update(nts=6,
                                                           qts_subdivisions=6)
    cfg["output_parameters"] = {"csv_output": {"csv_output_folder": "strict"}}
    got, want = run_both(cfg, *bases, name="strict.yaml")
    assert_results_match(got, want, strict=True)
    assert got["fvd"].shape[0] == 6
    assert got["courant"].shape == want["courant"].shape == \
        (6, dom["ids"].size, 3)
    f32_bar(got["courant"], want["courant"], strict=True)
    assert [p.name for p in got["written"]] == [
        "flowveldepth_202108231400.csv", "courant_202108231400.csv"]
    # the block skip changes the sweeps, not the fixed point
    skip = copy.deepcopy(cfg)
    skip["compute_parameters"]["strict_block_skip"] = True
    p = bases[0] / "strict_skip.yaml"
    yaml.safe_dump(skip, open(p, "w"))
    f32_bar(torch_cli.main_v04(["-f", str(p), "--cpu"])["fvd"], got["fvd"],
            strict=True)


def test_level_scan_default_compute_matches(geopackage_bases):
    """The schema's default compute parameters (``assume_short_ts`` and
    ``strict_iterative`` left out, both False): the level scan of
    ``route()`` in both packages, from the warm state of a short run set
    as in ``test_strict_iterative_matches``."""
    bases, dom = geopackage_bases
    warm = _geopackage_cfg(dom["ids"])
    warm["compute_parameters"]["forcing_parameters"]["nts"] = 12
    warm["output_parameters"] = {
        "lite_restart": {"lite_restart_output_directory": "warm_ls"}}
    run_both(warm, *bases, name="warm_ls.yaml")
    cfg = _geopackage_cfg(dom["ids"], return_courant=True, restart_parameters={
        "start_datetime": "2021-08-23_14:00",
        "lite_channel_restart_file": "warm_ls/channel_restart_202108231400",
        "lite_waterbody_restart_file":
            "warm_ls/waterbody_restart_202108231400"})
    del cfg["compute_parameters"]["assume_short_ts"]
    cfg["compute_parameters"]["forcing_parameters"].update(nts=6,
                                                           qts_subdivisions=6)
    cfg["output_parameters"] = {
        "csv_output": {"csv_output_folder": "level_scan"}}
    got, want = run_both(cfg, *bases, name="level_scan.yaml")
    assert_results_match(got, want, strict=True)
    assert got["fvd"].shape == (6, dom["ids"].size, 3)
    f32_bar(got["courant"], want["courant"], strict=True)
    assert_files_match(got["written"], want["written"], strict=True)


# ------------------------------------------------------------ (e), (f)

@pytest.mark.parametrize("change, item", [
    ({"hybrid_parameters": {"run_hybrid_routing": True,
                            "diffusive_domain": "domain/diffusive.yaml"}},
     "A10/A11"),
    ({"parallel_compute_method": "sharded"}, "A13")])
def test_waiting_branches_raise(geopackage_bases, tmp_path, change, item):
    """The two branches that waited for ROADMAP A10/A11 and A13; both
    route now.  Hybrid routing: on ``test_torch_hybrid``'s RouteLink
    domain the port's run equals the JAX command line's (MC rows and the
    appended mainstem at the f32 bar).  ``sharded`` (A13): the port's
    command in a 2-rank gloo group on the CPU (two run sets with lite
    restarts, outputs) equals the JAX command line sharded over this
    file's 8 CPU devices, and the port's one-process run, at the f32 bar;
    both ranks return the same result, rank 0 alone wrote the files, and
    neither rank imported JAX or launched a kernel.  Alone, one process
    with ``sharded`` routes on its device bit for bit as without it."""
    bases, dom = geopackage_bases
    if item == "A10/A11":
        from test_torch_hybrid import hybrid_config, write_hybrid_domain
        hbases = [tmp_path / "t", tmp_path / "j"]
        hdom = [write_hybrid_domain(b) for b in hbases][0]
        cfg = hybrid_config()
        cfg["compute_parameters"].update(change)
        got, want = run_both(cfg, *hbases, name="hybrid.yaml")
        n_ms = len(hdom["mainstem_ids"])
        np.testing.assert_array_equal(got["ids"], want["ids"])
        assert set(got["ids"][-n_ms:]) == set(hdom["mainstem_ids"])
        f32_bar(got["fvd"], want["fvd"])
        np.testing.assert_array_equal(got["diffusive"]["ids"],
                                      want["diffusive"]["ids"])
        return
    from troute_torch.parallel import ranks
    from troute_torch.parallel.group import spawn_ranks
    cfg = _geopackage_cfg(dom["ids"], **change)
    cfg["output_parameters"]["csv_output"]["csv_output_folder"] = \
        "out_sharded"
    cfg["output_parameters"]["parquet_output"]["parquet_output_folder"] = \
        "out_sharded"
    cfg["output_parameters"]["lite_restart"][
        "lite_restart_output_directory"] = "restart_sharded"
    p = bases[1] / "sharded.yaml"
    yaml.safe_dump(cfg, open(p, "w"))
    want = jax_cli.main_v04(["-f", str(p), "--cpu"])
    p = bases[0] / "sharded.yaml"
    yaml.safe_dump(cfg, open(p, "w"))
    out = spawn_ranks(ranks.cli_main, 2, args=(["-f", str(p), "--cpu"],),
                      timeout=300)
    got = out[0]
    for rank in out:
        assert rank["launches"] == 0 and rank["foreign"] == []
        np.testing.assert_array_equal(rank["fvd"], got["fvd"])
        np.testing.assert_array_equal(rank["ids"], want["ids"])
    assert out[1]["written"] == []
    assert [Path(w).name for w in got["written"]] == \
        [w.name for w in want["written"]]
    assert all(Path(w).is_file() for w in got["written"])
    assert got["fvd"].shape == want["fvd"].shape == (24, dom["ids"].size, 3)
    f32_bar(got["fvd"], want["fvd"])
    for g, w in zip(got["final_state"], want["final_state"]):
        f32_bar(g, w)
    assert_files_match([Path(w) for w in got["written"]], want["written"])
    plain = copy.deepcopy(cfg)
    del plain["compute_parameters"]["parallel_compute_method"]
    plain["output_parameters"] = {}
    p = bases[0] / "unsharded.yaml"
    yaml.safe_dump(plain, open(p, "w"))
    alone = torch_cli.main_v04(["-f", str(p), "--cpu"])
    f32_bar(got["fvd"], alone["fvd"])
    for g, w in zip(got["final_state"], alone["final_state"]):
        f32_bar(g, w)
    one = copy.deepcopy(cfg)
    one["output_parameters"] = {}
    p = bases[0] / "sharded_alone.yaml"
    yaml.safe_dump(one, open(p, "w"))
    single = torch_cli.main_v04(["-f", str(p), "--cpu"])
    np.testing.assert_array_equal(single["fvd"], alone["fvd"])
    for g, w in zip(single["final_state"], alone["final_state"]):
        np.testing.assert_array_equal(g, w)


def test_sharded_group_that_cannot_start_raises(geopackage_bases,
                                                monkeypatch):
    """Told by torchrun's environment to make a group on the card, where
    NCCL cannot start (this PyTorch has no NCCL; the card's presence is
    faked), the command line raises and leaves no group behind; it falls
    back neither to gloo nor to one process."""
    import socket

    import torch
    import torch.distributed as dist
    bases, dom = geopackage_bases
    cfg = _geopackage_cfg(dom["ids"], parallel_compute_method="sharded")
    cfg["output_parameters"] = {}
    p = bases[0] / "sharded_nccl.yaml"
    yaml.safe_dump(cfg, open(p, "w"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    with pytest.raises(RuntimeError, match="NCCL"):
        torch_cli.main_v04(["-f", str(p)])
    assert not dist.is_initialized()


def test_hybrid_without_diffusive_domain_refused_by_both_schemas(tmp_path):
    """``run_hybrid_routing: True`` without a ``diffusive_domain``: both
    packages' ``load_config`` refuse it with the same message, so neither
    command line reaches its hybrid branch."""
    from pydantic import ValidationError

    from troute_torch.config import load_config as torch_load
    from troute_tpu.config import load_config as jax_load
    cfg = geopackage_config()
    cfg["compute_parameters"]["hybrid_parameters"] = {
        "run_hybrid_routing": True}
    p = tmp_path / "no_domain.yaml"
    yaml.safe_dump(cfg, open(p, "w"))
    messages = []
    for load in (torch_load, jax_load):
        with pytest.raises(ValidationError,
                           match="run_hybrid_routing requires "
                                 "diffusive_domain") as err:
            load(p)
        messages.append([e["msg"] for e in err.value.errors()])
    assert messages[0] == messages[1]


def test_no_card_and_no_cpu_flag_raises(geopackage_bases, monkeypatch):
    """Without ``--cpu`` the command line wants a CUDA device and never
    picks the CPU by itself."""
    import torch
    bases, dom = geopackage_bases
    p = bases[0] / "nocard.yaml"
    yaml.safe_dump(_geopackage_cfg(dom["ids"]), open(p, "w"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        torch_cli.main_v04(["-f", str(p)])


def test_preprocess_only_returns_early(geopackage_bases):
    bases, dom = geopackage_bases
    cfg = _geopackage_cfg(dom["ids"])
    cfg["network_topology_parameters"]["preprocessing_parameters"] = {
        "preprocess_only": True, "preprocess_output_folder": "cache"}
    got, want = run_both(cfg, *bases, name="pre.yaml")
    assert got.keys() == want.keys() and got["fvd"].shape == want["fvd"].shape
    assert got["final_state"] is None and got["written"] == []
    assert (bases[0] / "cache" / "preprocess_output.pkl").exists()


def test_forcing_set_grouping_equal():
    files = [f"f{k}" for k in range(7)]
    for args in ((300, 12, 0, 2), (300, 12, 30, 1), (300, 12, 200, 24),
                 (60, 60, 61, 1)):
        assert torch_cli.build_forcing_sets(files, *args) == \
            jax_cli.build_forcing_sets(files, *args)


def test_module_entry_point(geopackage_bases):
    """``python -m troute_torch -f cfg.yaml --cpu`` runs the same command."""
    import subprocess
    import sys
    from pathlib import Path
    bases, dom = geopackage_bases
    cfg = _geopackage_cfg(dom["ids"])
    cfg["compute_parameters"]["forcing_parameters"]["nts"] = 2
    cfg["output_parameters"] = {"csv_output": {"csv_output_folder": "m_out"}}
    p = bases[0] / "module.yaml"
    yaml.safe_dump(cfg, open(p, "w"))
    root = Path(torch_cli.__file__).resolve().parent.parent
    res = subprocess.run(
        [sys.executable, "-m", "troute_torch", "-f", str(p), "--cpu"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "troute_torch timing summary" in res.stdout
    assert (bases[0] / "m_out" / "flowveldepth_202108231300.csv").exists()

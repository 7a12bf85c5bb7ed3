"""The port's network construction against the JAX package's.

A synthetic NHD domain (``RouteLink.nc`` + ``LAKEPARM.nc``, written with
``h5py``) and a synthetic HYFeatures geopackage (written with ``sqlite3``
by ``troute_torch/synthetic.py``) go through both ``build_network``s.  The
port's builder replaces the JAX builder's per-node Python loops with NumPy
lookups, so everything must be equal exactly: topology, channel and
reservoir parameters, initial state, gage rows and ids, lake crosswalk,
nexus maps.  Inputs come from a seed; a few hundred to a few thousand
segments, a handful of lakes and gages.

The writers here also make the domains of ``test_torch_cli.py``.
"""

import h5py
import numpy as np
import pandas as pd
import pytest

from troute_torch import synthetic
from troute_torch.config.schema import Config as TorchConfig
from troute_torch.network import builder as torch_builder
from troute_torch.network import graph as torch_graph
from troute_torch.network import hyfeatures as torch_hyf
from troute_tpu.config.schema import Config as JaxConfig
from troute_tpu.network import builder as jax_builder
from troute_tpu.network import graph as jax_graph
from troute_tpu.network import hyfeatures as jax_hyf

LAKE_PARAMS = (12.0, 1.2, 0.1, 8.0, 0.4, 11.0, 12.0, 0.9)  # after LkArea


def _chars(strings, width=15):
    return np.array([list(f"{s:<{width}}") for s in strings], "S1")


def synthetic_network(n, n_lakes, n_gages, seed):
    """(ids, down, chan, lake segment ids, gage segment ids, rng): a
    drainage forest with CONUS statistics; lake segments have an upstream
    and a downstream neighbour, gage segments are not lake segments."""
    ids, down = synthetic.synthetic_conus(n, n_basins=max(n // 40, 12),
                                          seed=seed)
    rng = np.random.default_rng(seed)
    chan = synthetic.channel_params(n, rng)
    inner = ids[np.isin(ids, down) & (down > 0)]
    lake_segs = rng.choice(inner, n_lakes, replace=False)
    gage_segs = rng.choice(np.setdiff1d(ids, lake_segs), n_gages,
                           replace=False)
    return ids, down, chan, lake_segs, gage_segs, rng


def write_routelink_domain(base, n=600, n_lakes=4, n_gages=6, seed=0):
    """``domain/RouteLink.nc`` and ``domain/LAKEPARM.nc`` under ``base``,
    in shuffled row order, each lake a footprint of two segments (a lake
    segment and its downstream neighbour when that has a way out).
    Returns a dict with the ids, the lake ids and the gage ids."""
    ids, down, chan, lake_segs, gage_segs, rng = synthetic_network(
        n, n_lakes, n_gages, seed)
    wb = np.full(n, -9999, np.int64)
    lake_ids = 7_000_000 + np.arange(n_lakes)
    for lk, seg in zip(lake_ids, lake_segs):
        wb[seg - 1] = lk
        nxt = down[seg - 1]
        if down[nxt - 1] > 0 and wb[nxt - 1] == -9999 \
                and nxt not in gage_segs:
            wb[nxt - 1] = lk
    gages = np.full(n, "", dtype=object)
    gage_ids = [f"{2_000_000 + k:08d}" for k in range(n_gages)]
    gages[gage_segs - 1] = gage_ids
    perm = rng.permutation(n)
    (base / "domain").mkdir(parents=True, exist_ok=True)
    with h5py.File(base / "domain" / "RouteLink.nc", "w") as f:
        f["link"] = ids[perm]
        f["to"] = down[perm]
        for name, key in (("Length", "dx"), ("n", "n"), ("nCC", "ncc"),
                          ("So", "s0"), ("BtmWdth", "bw"), ("TopWdth", "tw"),
                          ("TopWdthCC", "twcc"), ("ChSlp", "cs")):
            f[name] = chan[key][perm]
        f["NHDWaterbodyComID"] = wb[perm]
        f["gages"] = _chars(gages[perm])
        f["alt"] = rng.uniform(1, 500, n).astype(np.float32)
    with h5py.File(base / "domain" / "LAKEPARM.nc", "w") as f:
        # one lake more than the domain holds, and one listed twice
        lids = np.concatenate([lake_ids, [lake_ids[0], 7_999_999]])
        f["lake_id"] = lids
        f["LkArea"] = rng.uniform(1.0, 3.0, lids.size)
        for name, v in zip(("LkMxE", "OrificeA", "OrificeC", "OrificeE",
                            "WeirC", "WeirE", "WeirL", "ifd"), LAKE_PARAMS):
            f[name] = np.full(lids.size, v)
    return dict(ids=ids, down=down, lake_ids=lake_ids, gage_ids=gage_ids,
                gage_segs=gage_segs, rng=rng)


def routelink_config(**restart):
    return {
        "network_topology_parameters": {
            "supernetwork_parameters": {
                "geo_file_path": "domain/RouteLink.nc"},
            "waterbody_parameters": {
                "break_network_at_waterbodies": True,
                "level_pool": {"level_pool_waterbody_parameter_file_path":
                               "domain/LAKEPARM.nc"}}},
        "compute_parameters": {"restart_parameters": dict(restart)}}


def write_geopackage_domain(base, n=800, n_lakes=5, n_gages=8, seed=1):
    """``domain.gpkg`` under ``base`` (new-generation HYFeatures layout),
    each lake one flowpath.  Returns a dict as ``write_routelink_domain``."""
    ids, down, chan, lake_segs, gage_segs, rng = synthetic_network(
        n, n_lakes, n_gages, seed)
    lakes = {int(n + 100 + k): (int(seg), [rng.uniform(1.0, 3.0),
                                           *LAKE_PARAMS])
             for k, seg in enumerate(lake_segs)}
    gages = {int(s): f"{1_000_000 + k:08d}"
             for k, s in enumerate(gage_segs)}
    synthetic.write_hyfeatures_geopackage(base / "domain.gpkg", ids, down,
                                          chan, lakes, gages)
    return dict(ids=ids, down=down, lake_ids=np.asarray(list(lakes)),
                gage_ids=list(gages.values()), gage_segs=gage_segs, rng=rng)


def geopackage_config():
    return {
        "network_topology_parameters": {
            "supernetwork_parameters": {"geo_file_path": "domain.gpkg"},
            "waterbody_parameters": {
                "break_network_at_waterbodies": True,
                "level_pool": {"level_pool_waterbody_parameter_file_path":
                               "domain.gpkg"}}},
        "compute_parameters": {}}


def assert_built_equal(got, want):
    """Two ``BuiltNetwork``s (the port's and the JAX package's), field by
    field, exactly."""
    for name in ("ids", "downstream", "upstream", "level", "node_type",
                 "reservoir_rows"):
        g, w = getattr(got.topo, name), getattr(want.topo, name)
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, name
    assert got.topo.index_of == want.topo.index_of
    assert got.chan.keys() == want.chan.keys()
    for k in got.chan:
        np.testing.assert_array_equal(got.chan[k], want.chan[k], err_msg=k)
        assert got.chan[k].dtype == want.chan[k].dtype
    for name in ("res_params", "res_elev0", "res_outflow0", "q0", "qu0",
                 "depth0", "gage_rows", "segment_rows"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g, w, err_msg=name)
        assert g.dtype == w.dtype, name
    assert list(got.gage_ids) == list(want.gage_ids)
    assert got.gage_ids.dtype == want.gage_ids.dtype
    assert got.lake_crosswalk == want.lake_crosswalk
    assert got.nexus_of_wb == want.nexus_of_wb
    assert got.wb_downstream_nexus == want.wb_downstream_nexus
    assert (got.hyf_da is None) == (want.hyf_da is None)
    if got.hyf_da is not None:
        assert tuple(got.hyf_da) == tuple(want.hyf_da)


def _build_both(cfg, base):
    return (torch_builder.build_network(TorchConfig.model_validate(cfg), base),
            jax_builder.build_network(JaxConfig.model_validate(cfg), base))


def test_routelink_domain_equal(tmp_path):
    dom = write_routelink_domain(tmp_path)
    got, want = _build_both(routelink_config(), tmp_path)
    assert_built_equal(got, want)
    assert got.topo.reservoir_rows.size == dom["lake_ids"].size
    assert sorted(got.gage_ids) == dom["gage_ids"]
    assert got.n_nodes < dom["ids"].size      # footprints collapsed


def test_routelink_domain_with_mask_and_no_lakes_equal(tmp_path):
    dom = write_routelink_domain(tmp_path, seed=3)
    keep = dom["ids"][: dom["ids"].size // 2]
    np.savetxt(tmp_path / "domain" / "mask.txt", keep, fmt="%d")
    cfg = routelink_config()
    cfg["network_topology_parameters"]["supernetwork_parameters"][
        "mask_file_path"] = "domain/mask.txt"
    cfg["network_topology_parameters"]["waterbody_parameters"] = {
        "break_network_at_waterbodies": False}
    got, want = _build_both(cfg, tmp_path)
    assert_built_equal(got, want)
    assert got.n_nodes == keep.size and got.topo.reservoir_rows.size == 0


def test_routelink_restart_state_equal(tmp_path):
    """Lite restart pickles (with ids the network does not hold, and one
    id listed twice: the last row wins) and WRF-Hydro restart files give
    both builders the same initial state."""
    dom = write_routelink_domain(tmp_path, seed=4)
    rng, ids = dom["rng"], dom["ids"]
    some = np.concatenate([rng.choice(ids, 300, replace=False),
                           [ids[5], ids[5], 99_999_999]])
    chan_df = pd.DataFrame({"qu0": rng.uniform(0, 5, some.size),
                            "qd0": rng.uniform(0, 5, some.size),
                            "h0": rng.uniform(0, 2, some.size)}, index=some)
    lakes = np.concatenate([dom["lake_ids"][:3], [123]])
    wb_df = pd.DataFrame({"qd0": rng.uniform(0, 5, lakes.size),
                          "h0": rng.uniform(9, 11, lakes.size)}, index=lakes)
    (tmp_path / "restart").mkdir()
    chan_df.to_pickle(tmp_path / "restart" / "channel")
    wb_df.to_pickle(tmp_path / "restart" / "waterbody")
    got, want = _build_both(routelink_config(
        lite_channel_restart_file="restart/channel",
        lite_waterbody_restart_file="restart/waterbody"), tmp_path)
    assert_built_equal(got, want)
    assert (got.q0 != 0).sum() > 250

    with h5py.File(tmp_path / "domain" / "RouteLink.nc") as f:
        n = f["link"].shape[0]
    with h5py.File(tmp_path / "restart" / "HYDRO_RST.nc", "w") as f:
        f["qlink1"] = rng.uniform(0, 5, n).astype(np.float32)
        f["qlink2"] = rng.uniform(0, 5, n).astype(np.float32)
        f["hlink"] = rng.uniform(0, 2, n).astype(np.float32)
        n_l = dom["lake_ids"].size + 2       # LAKEPARM.nc's rows
        f["resht"] = rng.uniform(9, 11, n_l).astype(np.float32)
        f["qlakeo"] = rng.uniform(0, 5, n_l).astype(np.float32)
    got, want = _build_both(routelink_config(
        wrf_hydro_channel_restart_file="restart/HYDRO_RST.nc",
        wrf_hydro_channel_ID_crosswalk_file="domain/RouteLink.nc",
        wrf_hydro_waterbody_restart_file="restart/HYDRO_RST.nc",
        wrf_hydro_waterbody_ID_crosswalk_file="domain/LAKEPARM.nc"),
        tmp_path)
    assert_built_equal(got, want)
    assert (got.depth0 != 0).all()


def test_geopackage_domain_equal(tmp_path):
    dom = write_geopackage_domain(tmp_path)
    got, want = _build_both(geopackage_config(), tmp_path)
    assert_built_equal(got, want)
    assert got.topo.reservoir_rows.size == dom["lake_ids"].size
    assert sorted(got.gage_ids) == sorted(dom["gage_ids"])
    assert len(got.nexus_of_wb) == dom["ids"].size


def test_geopackage_readers_equal(tmp_path):
    """``read_geopkg``, ``read_lake_attributes`` and ``read_qlat_nexout``
    of both packages on one geopackage and its NEXOUT files, the parquet
    cache of the forcing included."""
    dom = write_geopackage_domain(tmp_path, seed=2)
    got = torch_hyf.read_geopkg(tmp_path / "domain.gpkg")
    want = jax_hyf.read_geopkg(tmp_path / "domain.gpkg")
    for name in ("ids", "downstream", "waterbody"):
        np.testing.assert_array_equal(getattr(got[0], name),
                                      getattr(want[0], name))
    for k in want[0].channel:
        np.testing.assert_array_equal(got[0].channel[k], want[0].channel[k])
    assert list(got[0].gages) == list(want[0].gages)
    assert got[1] == want[1] and got[2] == want[2]
    assert tuple(got[3]) == tuple(want[3])
    for g, w in zip(torch_hyf.read_lake_attributes(tmp_path / "domain.gpkg"),
                    jax_hyf.read_lake_attributes(tmp_path / "domain.gpkg")):
        if isinstance(w, dict):
            assert g == w
        else:
            np.testing.assert_array_equal(g, w)
    files = []
    for k in range(3):
        files.append(tmp_path / f"20210823{13 + k}00NEXOUT.csv")
        synthetic.write_nexout_csv(files[-1], dom["ids"][::2],
                                   dom["rng"].uniform(0, 1, (dom["ids"].size + 1) // 2))
    order = dom["rng"].permutation(dom["ids"])
    want_q = jax_hyf.read_qlat_nexout(files, order, want[1])
    for folder in (None, tmp_path / "bin_t", tmp_path / "bin_t"):
        got_q = torch_hyf.read_qlat_nexout(files, order, got[1],
                                           binary_folder=folder)
        np.testing.assert_array_equal(got_q, want_q)
    assert want_q.shape == (3, order.size) and (want_q > 0).mean() > 0.4


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_functions_equal(seed):
    """The dict-of-lists graph helpers the builder calls."""
    ids, down, _, lake_segs, _, _ = synthetic_network(500, 4, 0, seed)
    conns = [g.extract_connections(ids.tolist(), down.tolist(), {0})
             for g in (torch_graph, jax_graph)]
    assert conns[0] == conns[1]
    wbs = {int(s): 9000 + k for k, s in enumerate(lake_segs)}
    assert torch_graph.replace_waterbodies(conns[0], wbs) == \
        jax_graph.replace_waterbodies(conns[1], wbs)
    rconn = torch_graph.reverse_network(conns[0])
    assert rconn == jax_graph.reverse_network(conns[1])
    assert torch_graph.dfs_reach_decomposition(rconn) == \
        jax_graph.dfs_reach_decomposition(rconn)


def test_positions_of_takes_the_last_occurrence():
    keys = np.array([7, 3, 7, 9, 3])
    at, found = torch_builder.positions_of(keys, [3, 7, 8, 9])
    assert found.tolist() == [True, True, False, True]
    assert at[found].tolist() == [4, 2, 3]
    at, found = torch_builder.positions_of(np.zeros(0, np.int64), [1])
    assert not found.any()


def test_preprocessing_cache_round_trip(tmp_path):
    """``preprocess_only`` pickles the built network; a second build with
    ``use_preprocessed_data`` reads it back equal."""
    write_geopackage_domain(tmp_path, n=300, n_lakes=2, n_gages=3)
    cfg = geopackage_config()
    cfg["network_topology_parameters"]["preprocessing_parameters"] = {
        "preprocess_only": True, "preprocess_output_folder": "cache",
        "preprocess_output_filename": "net"}
    first = torch_builder.build_network(TorchConfig.model_validate(cfg),
                                        tmp_path)
    assert (tmp_path / "cache" / "net.pkl").exists()
    cfg["network_topology_parameters"]["preprocessing_parameters"] = {
        "use_preprocessed_data": True, "preprocess_output_folder": "cache",
        "preprocess_output_filename": "net"}
    again = torch_builder.build_network(TorchConfig.model_validate(cfg),
                                        tmp_path)
    assert_built_equal(again, first)

"""The port's hybrid MC-diffusive routing (``troute_torch/routing/hybrid.py``
and the command line's hybrid branch) against the JAX package's, on the
same synthetic inputs made from a seed.

``write_hybrid_domain`` writes them with h5py, pyarrow and PyYAML: a
RouteLink domain (``test_torch_network.write_routelink_domain``, 600
segments) whose two largest basins each carry a diffusive mainstem tree (a
trunk of up to 14 segments and a branch of up to 5) with bed altitudes
that fall downstream; the ``diffusive_domain`` YAML; natural cross
sections as NetCDF and as HYFeatures parquet; a SCHISM-shaped coastal
depth file with its crosswalk YAML; a refactored mainstem (a segment and
its downstream neighbour merged into one link where no tributary enters
between them) with its topobathy; CHRTOUT forcing for three hours.
``test_torch_bmi.py`` and ``test_torch_cli.py`` use it too.

Tolerances:
* ``HybridDomain`` (reaches, reach topology, tributaries, tailwater
  groups, natural sections, coastal rows): equal to JAX's exactly; the
  built solver domains' arrays within rtol/atol 1e-12 (the same NumPy
  table builders, float64);
* the command line, port (``--cpu``) against JAX: ids exact; the MC flows
  and, in every form, the diffusive flows and depths at the f32 bar of
  ``test_torch_cli.py`` (both route MC in float32 with different ``pow``
  implementations, and the tributary flows carry that into the mainstem);
* in float64, ``run_mainstem`` fed the JAX run's own MC flows equals the
  JAX diffusive output at rtol 1e-9 (atol 1e-9);
* float32 with uniform 128-entry tables: the f32 bar on flows, and depths
  within 1e-3 m (surfaces carry f32 rounding of ~1e-5 m on ~10 m datums,
  and the uniform grids are resampled in f32).
"""

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from test_torch_cli import f32_bar
from test_torch_network import write_routelink_domain
from troute_torch import cli as torch_cli
from troute_torch.config import load_config as torch_load_config
from troute_torch.routing import hybrid as thybrid
from troute_tpu import cli as jax_cli
from troute_tpu.config import load_config as jax_load_config
from troute_tpu.routing import hybrid as jhybrid

torch.set_num_threads(1)

T0 = pd.Timestamp("2021-08-23 13:00")
START = "2021-08-23_13:00"
REFAC_OFFSET = 50_000_000


def _upstream(ids, down):
    up = {int(s): [] for s in ids}
    for s, d in zip(ids, down):
        if int(d) in up:
            up[int(d)].append(int(s))
    return up


def _subtree_sizes(ids, down, up):
    size = {}
    order = list(np.sort(ids))   # hops go to larger ids: upstream first
    for s in order:
        size[int(s)] = 1 + sum(size[u] for u in up[int(s)])
    return size


def _mainstem_tree(tw, up, size, avoid, trunk_len, branch_len):
    """A trunk from ``tw`` up the largest subtree, and one branch from the
    trunk's second junction up its other largest child."""
    trunk = [tw]
    junctions = []
    while len(trunk) < trunk_len:
        kids = sorted((u for u in up[trunk[-1]] if u not in avoid),
                      key=lambda u: -size[u])
        if not kids:
            break
        if len(kids) > 1:
            junctions.append(kids[1])
        trunk.append(kids[0])
    links = list(trunk)
    if len(junctions) > 1:
        s = junctions[1]
        for _ in range(branch_len):
            links.append(s)
            kids = sorted((u for u in up[s] if u not in avoid),
                          key=lambda u: -size[u])
            if not kids:
                break
            s = kids[0]
    return links


def write_hybrid_domain(base, seed=0, n=600, trunk_len=14, branch_len=5):
    """Everything under ``base``; returns a dict of ids, the mainstem and
    the tailwaters."""
    dom = write_routelink_domain(base, n=n, n_lakes=2, n_gages=4, seed=seed)
    ids, down = dom["ids"], dom["down"]
    rng = np.random.default_rng(seed + 300)
    up = _upstream(ids, down)
    size = _subtree_sizes(ids, down, up)
    with h5py.File(base / "domain" / "RouteLink.nc", "r") as f:
        wb = dict(zip(f["link"][...].tolist(),
                      f["NHDWaterbodyComID"][...].tolist()))
    lake_segs = {s for s, w in wb.items() if w > 0}
    avoid = set(lake_segs)
    for s in lake_segs:                     # nor flow into a lake segment
        avoid.update(up[s])
        avoid.add(int(down[s - 1]))
    tailwaters = [int(s) for s in ids[down == 0] if s not in avoid]
    tailwaters = sorted(tailwaters, key=lambda s: -size[s])[:2]
    mainstem = {}
    for tw in tailwaters:
        links = _mainstem_tree(tw, up, size, avoid, trunk_len, branch_len)
        mainstem[tw] = links
    ms = [s for v in mainstem.values() for s in v]
    ms_set = set(ms)

    # river-like channels on the mainstem, bed altitudes that fall
    # downstream at each segment's slope everywhere
    with h5py.File(base / "domain" / "RouteLink.nc", "r+") as f:
        link = f["link"][...]
        row = {int(s): k for k, s in enumerate(link)}
        to = f["to"][...]
        chan = {k: f[k][...] for k in ("Length", "So", "BtmWdth", "TopWdth",
                                       "TopWdthCC", "ChSlp")}
        for s in ms:
            k = row[s]
            chan["So"][k] = rng.uniform(3e-4, 2e-3)
            chan["BtmWdth"][k] = rng.uniform(20.0, 40.0)
            chan["TopWdth"][k] = rng.uniform(60.0, 100.0)
            chan["TopWdthCC"][k] = rng.uniform(200.0, 400.0)
            chan["ChSlp"][k] = rng.uniform(0.5, 1.5)
        alt = np.zeros(link.size, np.float32)
        for s in sorted(row, reverse=True):        # downstream first
            k = row[s]
            d = int(to[k])
            base_alt = alt[row[d]] if d in row else 2.0
            alt[k] = base_alt + chan["So"][k] * chan["Length"][k]
        for name, v in chan.items():
            f[name][...] = v
        f["alt"][...] = alt
    alt_of = {s: float(alt[row[s]]) for s in ms}
    (base / "domain" / "diffusive.yaml").write_text(yaml.safe_dump(
        {tw: {"links": v} for tw, v in mainstem.items()}))

    # natural cross sections: a V-notched trapezoid of 9 points per link,
    # its floor at the link's altitude
    links, xs, zs, ns = [], [], [], []
    for s in ms:
        width = rng.uniform(60.0, 120.0)
        x = np.linspace(0.0, width, 9)
        depth = np.array([4.0, 3.0, 1.5, 0.6, 0.0, 0.5, 1.4, 2.8, 4.2])
        links += [s] * 9
        xs.append(x)
        zs.append(alt_of[s] + depth * rng.uniform(0.8, 1.2))
        ns.append(np.full(9, rng.uniform(0.03, 0.06)))
    xs, zs, ns = map(np.concatenate, (xs, zs, ns))
    with h5py.File(base / "domain" / "topobathy.nc", "w") as f:
        f["link"] = np.asarray(links, np.int64)
        f["xid_d"], f["z"], f["n"] = xs, zs, ns
    pd.DataFrame({"hy_id": [f"wb-{s}" for s in links], "xid_d": xs,
                  "z": zs, "n": ns}).to_parquet(
        base / "domain" / "topobathy.parquet")

    # SCHISM-shaped coastal file: elev [time, node], depth [node], hourly
    # from 12:00; the first tailwater is crosswalked to node 1
    n_t, n_nodes = 8, 3
    with h5py.File(base / "schout.nc", "w") as f:
        t = np.arange(1, n_t + 1) * 3600.0
        f["time"] = t
        f["time"].attrs["units"] = "seconds since 2021-08-23 12:00:00+00:00"
        f["elev"] = rng.uniform(0.5, 1.0, (n_t, n_nodes)) \
            + np.linspace(0.0, 1.5, n_t)[:, None]
        f["depth"] = np.array([3.0, 2.5, 4.0])
    (base / "domain" / "coastal.yaml").write_text(
        yaml.safe_dump({tailwaters[0]: 1, 999: 2}))

    _write_refactored(base, mainstem, ids, down, up, ms_set, alt_of, rng)

    (base / "channel_forcing").mkdir()
    for k in range(3):
        stamp = (T0 + pd.Timedelta(hours=k)).strftime("%Y%m%d%H%M")
        with h5py.File(base / "channel_forcing"
                       / f"{stamp}.CHRTOUT_DOMAIN1", "w") as f:
            f["feature_id"] = ids
            f["q_lateral"] = rng.uniform(0.0, 1.5, ids.size
                                         ).astype(np.float32)
    return dict(ids=ids, down=down, mainstem=mainstem, mainstem_ids=ms,
                tailwaters=tailwaters, lake_ids=dom["lake_ids"])


def _write_refactored(base, mainstem, ids, down, up, ms_set, alt_of, rng):
    """Refactored domain: a mainstem segment and its downstream neighbour
    merge into one link where that neighbour has no other upstream
    segment; the rest map one to one.  Length shares are written as the
    reference writes them ("seg.1" is the whole segment)."""
    spec = {}
    link_rows = []
    for tw, links in mainstem.items():
        links_set = set(links)
        rlink_of, members = {}, {}
        for s in sorted(links):      # upstream first (smaller ids)
            if s in rlink_of:
                continue
            d = int(down[s - 1])
            rl = REFAC_OFFSET + s
            rlink_of[s] = rl
            members[rl] = [s]
            if d in links_set and d not in rlink_of and len(up[d]) == 1 \
                    and d != tw:
                rlink_of[d] = rl
                members[rl].append(d)
        incoming = {}
        for s in links:
            for u in up[s]:
                if u not in ms_set:
                    incoming[u] = rlink_of[s]
        for rl, mem in members.items():
            last = mem[-1]
            d = int(down[last - 1])
            to = rlink_of.get(d, 0)
            for s in mem:
                for x, dz in ((0.0, 3.0), (20.0, 0.0), (45.0, 0.2),
                              (70.0, 3.5)):
                    link_rows.append((rl, to, x, alt_of[mem[-1]] + dz,
                                      rng.uniform(0.03, 0.05)))
        spec[tw] = {"rlinks": sorted(members),
                    "incoming_tribs": incoming,
                    "lengthMap": {rl: ",".join(f"{s}.1" for s in mem)
                                  for rl, mem in members.items()},
                    "refac_tw": rlink_of[tw]}
    (base / "domain" / "refactored.yaml").write_text(yaml.safe_dump(spec))
    rows = np.asarray(link_rows)
    with h5py.File(base / "domain" / "refactored_topobathy.nc", "w") as f:
        f["link"] = rows[:, 0].astype(np.int64)
        f["to"] = rows[:, 1].astype(np.int64)
        f["xid_d"], f["z"], f["n"] = rows[:, 2], rows[:, 3], rows[:, 4]


def hybrid_config(**hybrid):
    """A short-mode control file over ``write_hybrid_domain``'s files:
    CHRTOUT forcing, 24 steps in 2 run sets, hybrid routing with the given
    ``hybrid_parameters`` on top of the trapezoid default."""
    hp = {"run_hybrid_routing": True,
          "diffusive_domain": "domain/diffusive.yaml"}
    hp.update(hybrid)
    return {
        "log_parameters": {"showtiming": False, "log_level": "INFO"},
        "network_topology_parameters": {
            "supernetwork_parameters": {
                "geo_file_path": "domain/RouteLink.nc"},
            "waterbody_parameters": {
                "break_network_at_waterbodies": True,
                "level_pool": {"level_pool_waterbody_parameter_file_path":
                               "domain/LAKEPARM.nc"}}},
        "compute_parameters": {
            "compute_kernel": "V02-structured", "assume_short_ts": True,
            "restart_parameters": {"start_datetime": START},
            "hybrid_parameters": hp,
            "forcing_parameters": {
                "dt": 300, "qts_subdivisions": 12, "nts": 24,
                "max_loop_size": 1, "qlat_input_folder": "channel_forcing",
                "qlat_file_pattern_filter": "*.CHRTOUT_DOMAIN1"},
            "data_assimilation_parameters": {}},
        "output_parameters": {}}


# --------------------------------------------------------------- cases

NATURAL_NC = dict(use_natl_xsections=True,
                  topobathy_domain="domain/topobathy.nc")
CASES = {
    "trapezoid_f64_pinned": dict(diffusive_dtype="float64",
                                 diffusive_table_nel=0),
    "trapezoid_auto": {},
    "trapezoid_f32_uniform": dict(diffusive_dtype="float32",
                                  diffusive_table_nel=128),
    "natural_netcdf": NATURAL_NC,
    "natural_parquet": dict(use_natl_xsections=True,
                            topobathy_domain="domain/topobathy.parquet"),
    "coastal": dict(coastal_boundary_domain="domain/coastal.yaml"),
    "batching_never": dict(diffusive_batching="never"),
    "refactored": dict(run_refactored_network=True,
                       refactored_domain="domain/refactored.yaml",
                       refactored_topobathy_domain=(
                           "domain/refactored_topobathy.nc")),
}


def case_config(name):
    cfg = hybrid_config(**CASES[name])
    if name == "coastal":
        cfg["compute_parameters"]["forcing_parameters"][
            "coastal_boundary_input_file"] = "schout.nc"
    return cfg


def load_hybrid(module, cfg, base):
    """``module.HybridDomain`` of a control file, loaded as the command
    line loads it (topobathy, refactored network, coastal boundary)."""
    hp = cfg.compute_parameters.hybrid_parameters
    hyb = module.HybridDomain(cfg, base)
    if hp.run_refactored_network:
        hyb.load_refactored(base / hp.refactored_domain,
                            base / hp.refactored_topobathy_domain)
    elif hp.use_natl_xsections:
        hyb.load_topobathy(base / hp.topobathy_domain)
    if hp.coastal_boundary_domain:
        assert hyb.load_coastal_boundary(
            base / cfg.compute_parameters.forcing_parameters
            .coastal_boundary_input_file,
            base / hp.coastal_boundary_domain, T0)
    return hyb


@pytest.fixture(scope="module")
def bases(tmp_path_factory):
    """Two copies of one domain: the port's and the JAX package's."""
    out = [tmp_path_factory.mktemp(k) for k in ("hy_torch", "hy_jax")]
    doms = [write_hybrid_domain(b) for b in out]
    return out, doms[0]


def _both_hybrids(bases, name):
    (bt, bj), _ = bases
    p = bt / f"{name}.yaml"
    yaml.safe_dump(case_config(name), open(p, "w"))
    return (load_hybrid(thybrid, torch_load_config(p), bt),
            load_hybrid(jhybrid, jax_load_config(p), bt))


def _arrays_equal(got, want, what):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, what
    np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("name", ["trapezoid_auto", "natural_netcdf",
                                  "natural_parquet", "coastal",
                                  "refactored"])
def test_hybrid_domain_matches_jax(bases, name):
    """The reach split, tributaries, tailwater groups, natural sections
    and coastal rows exactly, and the built solver domains (whole and per
    tailwater tree) within rtol/atol 1e-12."""
    th, jh = _both_hybrids(bases, name)
    assert th.reaches == jh.reaches and len(th.reaches) > 4
    assert th.mainstem_set == jh.mainstem_set
    assert th.trib_segments == jh.trib_segments and th.trib_segments
    assert th.seg_reach == jh.seg_reach and th.refac == jh.refac
    for f in ("ds_reach", "trib_reach", "trib_node"):
        _arrays_equal(getattr(th, f), getattr(jh, f), f)
    for a, b in zip(th.reach_nodes, jh.reach_nodes):
        assert a.keys() == b.keys()
        for k in a:
            _arrays_equal(a[k], b[k], k)
    groups = th.tailwater_groups()
    assert len(groups) == 2
    for a, b in zip(groups, jh.tailwater_groups()):
        _arrays_equal(a, b, "tailwater group")
    nat_t = getattr(th, "natural_xsec", None)
    nat_j = getattr(jh, "natural_xsec", None)
    assert (nat_t is None) == (nat_j is None)
    if nat_t is not None:
        assert nat_t.keys() == nat_j.keys() and nat_t
        for k in nat_t:
            for a, b in zip(nat_t[k], nat_j[k]):
                _arrays_equal(a, b, f"natural section {k}")
    if name == "coastal":
        np.testing.assert_array_equal(th.coastal_db, jh.coastal_db)
        assert th.coastal_dt_db == jh.coastal_dt_db == 3600.0
        assert np.isfinite(th.coastal_db).any()
    rng = np.random.default_rng(7)
    ms = sorted(th.mainstem_set)
    qlat_rows = {s: rng.uniform(0.0, 1.0, 3) for s in ms}
    trib_q = rng.uniform(1.0, 20.0, (25, len(th.trib_segments)))
    for idx in [None] + groups:
        kw = dict(dt_qlat=3600.0, trib_q=trib_q, dt_trib=300.0,
                  dtini=300.0, reach_idx=idx)
        tdom = th.build_diffusive_domain(qlat_rows, device="cpu", **kw)
        jdom = jh.build_diffusive_domain(qlat_rows, **kw)
        for f in tdom._fields:
            g, w = getattr(tdom, f), getattr(jdom, f)
            if g is None or isinstance(g, float):
                assert g == w, f
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       rtol=1e-12, atol=1e-12, err_msg=f)


def test_empty_save_list_gives_empty_arrays(bases):
    """``saves_to_segments([])`` returns an empty series per mainstem
    segment where the JAX package raises IndexError
    (``troute_tpu/routing/hybrid.py:545``)."""
    th, jh = _both_hybrids(bases, "trapezoid_auto")
    trib_q = np.ones((3, len(th.trib_segments)))
    tdom = th.build_diffusive_domain({}, 3600.0, trib_q, 300.0, 300.0,
                                     device="cpu")
    q, d = th.saves_to_segments([], tdom)
    assert set(q) == set(d) == th.mainstem_set
    assert all(v.shape == (0,) for v in list(q.values()) + list(d.values()))
    qs, ys = th._saves_to_host([], (2, 3, 4))
    assert qs.shape == ys.shape == (0, 2, 3, 4)
    with pytest.raises(IndexError):
        jh.saves_to_segments([], jh.build_diffusive_domain(
            {}, 3600.0, trib_q, 300.0, 300.0))


# ------------------------------------------------------- command lines

@pytest.fixture(scope="module")
def cli_runs(bases):
    """Both command lines per case, run once and shared."""
    (bt, bj), _ = bases
    cache = {}

    def get(name):
        if name not in cache:
            out = []
            for cli, base in ((torch_cli, bt), (jax_cli, bj)):
                p = base / f"{name}.yaml"
                yaml.safe_dump(case_config(name), open(p, "w"))
                out.append(cli.main_v04(["-f", str(p), "--cpu"]))
            cache[name] = tuple(out)
        return cache[name]
    return get


def _same_mc_input(bases, name, want):
    """The port's ``run_mainstem`` fed the JAX run's MC flows."""
    (bt, _), _ = bases
    cfg = torch_load_config(bt / f"{name}.yaml")
    fp = cfg.compute_parameters.forcing_parameters
    files = sorted((bt / "channel_forcing").glob("*.CHRTOUT_DOMAIN1"))
    sets = torch_cli.build_forcing_sets(files, float(fp.dt),
                                        fp.qts_subdivisions, fp.nts,
                                        fp.max_loop_size)
    n_mc = want["fvd"].shape[1] - want["diffusive"]["ids"].size
    return thybrid.run_mainstem(
        load_hybrid(thybrid, cfg, bt), want["fvd"][:, :n_mc],
        want["built"].topo.ids, want["built"].q0,
        [f for r in sets for f in r["qlat_files"]], float(fp.dt),
        fp.qts_subdivisions, cfg.compute_parameters.hybrid_parameters,
        "cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_command_line_hybrid_matches_jax(bases, cli_runs, name):
    got, want = cli_runs(name)
    (_, _), dom = bases
    n_ms = len(dom["mainstem_ids"])
    np.testing.assert_array_equal(got["ids"], want["ids"])
    assert got["fvd"].shape == want["fvd"].shape == (
        24, dom["ids"].size - 2, 3)   # two lakes of two segments each
    assert got["fvd"].dtype == want["fvd"].dtype == np.float32
    gd, wd = got["diffusive"], want["diffusive"]
    np.testing.assert_array_equal(gd["ids"], wd["ids"])
    assert set(gd["ids"].tolist()) == set(dom["mainstem_ids"])
    # the appended mainstem columns hold the diffusive flow, 0 and depth
    np.testing.assert_array_equal(got["fvd"][:, -n_ms:, 0],
                                  gd["q"].astype(np.float32))
    assert not got["fvd"][:, -n_ms:, 1].any()
    for k in ("q", "depth"):
        assert gd[k].shape == wd[k].shape == (24, n_ms)
        assert np.isfinite(gd[k]).all() and (gd["q"] > 0).all()
    f32_bar(got["fvd"][:, :-n_ms], want["fvd"][:, :-n_ms])
    f32_bar(gd["q"], wd["q"])
    if name == "trapezoid_f32_uniform":
        np.testing.assert_allclose(gd["depth"], wd["depth"], rtol=0,
                                   atol=1e-3)
        return
    f32_bar(gd["depth"], wd["depth"])
    same = _same_mc_input(bases, name, want)
    assert same["dtype"] == "float64" and same["nel"] is None
    for k in ("q", "depth"):
        np.testing.assert_allclose(same["diffusive"][k], wd[k], rtol=1e-9,
                                   atol=1e-9, err_msg=k)
    if name == "trapezoid_auto":
        # "auto" resolves to float64 with exact tables on the CPU
        pinned = cli_runs("trapezoid_f64_pinned")[0]["diffusive"]
        for k in ("q", "depth"):
            np.testing.assert_array_equal(gd[k], pinned[k])
    if name == "natural_parquet":
        nat = cli_runs("natural_netcdf")[0]["diffusive"]
        for k in ("q", "depth"):
            np.testing.assert_array_equal(gd[k], nat[k])
    if name in ("batching_never", "coastal", "natural_netcdf",
                "refactored"):
        base = cli_runs("trapezoid_auto")[0]["diffusive"]
        if name == "batching_never":
            for k in ("q", "depth"):
                np.testing.assert_allclose(gd[k], base[k], rtol=1e-12,
                                           atol=1e-12)
        else:
            assert not np.allclose(gd["depth"], base["depth"], rtol=1e-3)


def test_mainstem_qlat_sources_match_jax(bases, tmp_path):
    """The mainstem's lateral inflow from each source the JAX command line
    reads (``troute_tpu/cli.py:838-859``): CHRTOUT files, a short CSV
    (its last row repeated up to the run's rows), a constant; equal."""
    from troute_tpu.io.forcing import read_qlat_chrtout, read_qlat_csv
    (bt, _), _ = bases
    th, _ = _both_hybrids(bases, "trapezoid_auto")
    ms_ids = np.asarray(sorted(th.mainstem_set), np.int64)
    files = sorted((bt / "channel_forcing").glob("*.CHRTOUT_DOMAIN1"))
    ids, ql = thybrid.mainstem_qlat(th, files, 5)
    np.testing.assert_array_equal(ids, ms_ids)
    np.testing.assert_array_equal(ql, read_qlat_chrtout(files, ms_ids))
    csv = tmp_path / "ql.csv"
    rng = np.random.default_rng(3)
    pd.DataFrame(rng.uniform(0, 1, (ms_ids.size - 3, 2)),
                 index=ms_ids[3:]).to_csv(csv)
    want = read_qlat_csv(csv, ms_ids)
    want = np.concatenate([want, np.repeat(want[-1:], 3, 0)])
    np.testing.assert_array_equal(thybrid.mainstem_qlat(th, csv, 5)[1],
                                  want)
    assert not thybrid.mainstem_qlat(th, csv, 5)[1][:, :3].any()
    np.testing.assert_array_equal(
        thybrid.mainstem_qlat(th, 0.25, 4)[1],
        np.full((4, ms_ids.size), 0.25, np.float32))


def test_sharded_mainstem_matches_unsharded_and_jax(bases):
    """``run_mainstem``'s sharded branch: 2 gloo ranks on the CPU share the
    batch's 2 tree lanes (float64, exact tables), fed the MC flows of the
    JAX command line run with ``parallel_compute_method: sharded`` (which
    shards its lanes over the 8 CPU devices, ``shard_batched_domains``).
    Both ranks return the whole result; it equals the port's unsharded
    batch on the same inputs at rtol 1e-12 and the JAX run's mainstem at
    the f64 bar above (rtol/atol 1e-9)."""
    from troute_torch.parallel import ranks
    from troute_torch.parallel.group import spawn_ranks
    (bt, bj), _ = bases
    cfg = case_config("trapezoid_auto")
    cfg["compute_parameters"]["parallel_compute_method"] = "sharded"
    for b in (bt, bj):
        yaml.safe_dump(cfg, open(b / "sharded.yaml", "w"))
    want = jax_cli.main_v04(["-f", str(bj / "sharded.yaml"), "--cpu"])
    tcfg = torch_load_config(bt / "sharded.yaml")
    fp = tcfg.compute_parameters.forcing_parameters
    files = sorted((bt / "channel_forcing").glob("*.CHRTOUT_DOMAIN1"))
    sets = torch_cli.build_forcing_sets(files, float(fp.dt),
                                        fp.qts_subdivisions, fp.nts,
                                        fp.max_loop_size)
    n_mc = want["fvd"].shape[1] - want["diffusive"]["ids"].size
    args = (load_hybrid(thybrid, tcfg, bt), want["fvd"][:, :n_mc],
            want["built"].topo.ids, want["built"].q0,
            [f for r in sets for f in r["qlat_files"]], float(fp.dt),
            fp.qts_subdivisions, tcfg.compute_parameters.hybrid_parameters,
            "cpu")
    out = spawn_ranks(ranks.run_cases, 2, args=(
        [dict(kind="mainstem", world=2, args=args)],), timeout=300)
    alone = thybrid.run_mainstem(*args)
    assert alone["dtype"] == "float64"
    for proc in out:
        assert proc["foreign"] == [] and proc["launches"] == 0
        rank = proc["cases"][0]
        np.testing.assert_array_equal(rank["ids"], alone["ids"])
        for k in ("q", "depth"):
            assert rank["diffusive"][k].shape == (24, len(alone["diffusive"][
                "ids"]))
            np.testing.assert_allclose(rank["diffusive"][k],
                                       alone["diffusive"][k], rtol=1e-12,
                                       atol=1e-12, err_msg=k)
            np.testing.assert_allclose(rank["diffusive"][k],
                                       want["diffusive"][k], rtol=1e-9,
                                       atol=1e-9, err_msg=k)

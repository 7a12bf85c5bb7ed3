"""The port's readers and writers against the JAX package's, on the same
arrays made from a seed.

Writers: both packages write from the same arrays into two folders, and the
files are equal variable by variable (NetCDF: every dataset's values, dtype
and attributes; the ``TITLE`` attribute names the writing package and is
left out) and as frames (CSV, parquet, pickles).  Readers: one file, read
by both, equal exactly.  A lite restart and a lastobs file written by one
package are read by the other.  Everything here is host code copied from
the JAX package, so there is no tolerance: equality is exact.
"""

import h5py
import numpy as np
import pandas as pd
import pytest

from troute_torch import da_assembly as t_gl
from troute_torch import parity as t_parity
from troute_torch.io import forcing as t_forcing
from troute_torch.io import netcdf as t_nc
from troute_torch.io import output as t_out
from troute_torch.io import restart as t_restart
from troute_torch.io import rfc as t_rfc
from troute_torch.io import routelink as t_rl
from troute_torch.io import timeslice as t_ts
from troute_torch.network import gl_constants as t_glc
from troute_torch.network import rfc_crosswalk as t_rfcx
from troute_tpu import da_assembly as j_gl
from troute_tpu import parity as j_parity
from troute_tpu.io import forcing as j_forcing
from troute_tpu.io import netcdf as j_nc
from troute_tpu.io import output as j_out
from troute_tpu.io import restart as j_restart
from troute_tpu.io import rfc as j_rfc
from troute_tpu.io import routelink as j_rl
from troute_tpu.io import timeslice as j_ts
from troute_tpu.network import gl_constants as j_glc
from troute_tpu.network import rfc_crosswalk as j_rfcx

T0 = pd.Timestamp("2021-08-23 13:00")
DT = 300.0


def _chars(strings, width=15):
    return np.array([list(f"{s:<{width}}") for s in strings], "S1")


def assert_nc_equal(a, b):
    """Two HDF5/NetCDF files: the same datasets with equal values, dtypes
    and attributes (``TITLE`` apart)."""
    def walk(path):
        out = {}
        with h5py.File(path, "r") as f:
            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    attrs = {k: np.asarray(v).tolist()
                             for k, v in obj.attrs.items()
                             if k not in ("DIMENSION_LIST", "REFERENCE_LIST")}
                    out[name] = (obj[...], attrs)
            f.visititems(visit)
            out["/"] = (np.zeros(0), {k: np.asarray(v).tolist()
                                      for k, v in f.attrs.items()
                                      if k != "TITLE"})
        return out
    da, db = walk(a), walk(b)
    assert da.keys() == db.keys()
    for name in da:
        (va, aa), (vb, ab) = da[name], db[name]
        assert va.dtype == vb.dtype and va.shape == vb.shape, name
        np.testing.assert_array_equal(va, vb, err_msg=name)
        assert aa == ab, name


@pytest.fixture
def run(tmp_path):
    """ids, a [nts, N, 3] flow/velocity/depth array, gages and lakes."""
    rng = np.random.default_rng(7)
    n, nts = 40, 24
    ids = rng.permutation(np.arange(101, 101 + n)).astype(np.int64)
    fvd = rng.uniform(0.0, 30.0, (nts, n, 3)).astype(np.float32)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    return dict(rng=rng, ids=ids, fvd=fvd, nts=nts, n=n, t=tmp_path / "t",
                j=tmp_path / "j", gage_rows=np.array([3, 17, 25]),
                gage_ids=np.array(["01234567", "07654321", "0999"],
                                  dtype=object),
                lake_rows=np.array([5, 30]))


def test_netcdf_writer_and_reader(run):
    rng = run["rng"]
    variables = {"a": rng.uniform(0, 1, (4, 3)), "b": np.arange(4),
                 "s": _chars(["x", "yz", "", "w"])}
    kw = dict(dims={"a": ("row", "col"), "b": ("row",)},
              attrs={"a": {"units": "m", "_FillValue": -1.0}},
              global_attrs={"note": "same"})
    t_nc.write_netcdf(run["t"] / "f.nc", variables, **kw)
    j_nc.write_netcdf(run["j"] / "f.nc", variables, **kw)
    assert_nc_equal(run["t"] / "f.nc", run["j"] / "f.nc")
    # CF unpacking: packed shorts with a fill value
    with h5py.File(run["t"] / "packed.nc", "w") as f:
        d = f.create_dataset("q", data=np.array([1, 2, -999, 4], np.int16))
        d.attrs["scale_factor"] = np.float32(0.01)
        d.attrs["add_offset"] = np.float32(1.5)
        d.attrs["_FillValue"] = np.int16(-999)
    with t_nc.NetCDFFile(run["t"] / "packed.nc") as a, \
            j_nc.NetCDFFile(run["t"] / "packed.nc") as b:
        np.testing.assert_array_equal(a.read("q"), b.read("q"))
        assert a.variables == b.variables and a.attrs("q") == b.attrs("q")
        assert np.isnan(a.read("q")[2])
    with t_nc.NetCDFFile(run["j"] / "f.nc") as a, \
            j_nc.NetCDFFile(run["t"] / "f.nc") as b:
        assert list(a.read_strings("s")) == list(b.read_strings("s"))
        assert a.attrs() == {"note": "same", **{k: v for k, v in
                                                a.attrs().items()
                                                if k == "TITLE"}}


def test_flowveldepth_csv_and_frames(run):
    a = t_out.write_flowveldepth_csv(run["t"] / "f.csv", run["ids"],
                                     run["fvd"], T0, DT)
    b = j_out.write_flowveldepth_csv(run["j"] / "f.csv", run["ids"],
                                     run["fvd"], T0, DT)
    assert a.read_text() == b.read_text()
    pd.testing.assert_frame_equal(pd.read_csv(a), pd.read_csv(b))
    fa = t_out.flowveldepth_dataframe(run["ids"], run["fvd"], T0, DT)
    fb = j_out.flowveldepth_dataframe(run["ids"], run["fvd"], T0, DT)
    pd.testing.assert_frame_equal(fa, fb)
    for frame, path in ((fa, run["t"] / "f.parquet"),
                        (fb, run["j"] / "f.parquet")):
        frame.columns = [f"{ts.isoformat()}_{v}" for ts, v in frame.columns]
        frame.to_parquet(path)
    pd.testing.assert_frame_equal(pd.read_parquet(run["t"] / "f.parquet"),
                                  pd.read_parquet(run["j"] / "f.parquet"))


def test_stream_output_files(run):
    nudge = run["rng"].uniform(-1, 1, (run["nts"], 3)).astype(np.float32)
    common = dict(nudge=nudge, nudge_ids=run["ids"][run["gage_rows"]],
                  file_hours=1.0, internal_frequency_min=30)
    for kind in (".nc", ".csv", ".pkl"):
        wa = t_out.write_stream_output(run["t"] / kind[1:], run["ids"],
                                       run["fvd"], T0, DT, output_type=kind,
                                       **common)
        wb = j_out.write_stream_output(run["j"] / kind[1:], run["ids"],
                                       run["fvd"], T0, DT, output_type=kind,
                                       **common)
        assert [p.name for p in wa] == [p.name for p in wb] and len(wa) == 2
        for pa, pb in zip(wa, wb):
            if kind == ".nc":
                assert_nc_equal(pa, pb)
            elif kind == ".csv":
                assert pa.read_text() == pb.read_text()
            else:
                pd.testing.assert_frame_equal(pd.read_pickle(pa),
                                              pd.read_pickle(pb))
    # the mask: a subset of segments and a nexus that sums its members
    mask = {"wb": [int(i) for i in run["ids"][:4]], "nex": [900]}
    members = {900: [int(run["ids"][5]), int(run["ids"][6])]}
    ga = t_out.apply_stream_mask(run["ids"], run["fvd"], None, mask, members)
    gb = j_out.apply_stream_mask(run["ids"], run["fvd"], None, mask, members)
    for x, y in zip(ga, gb):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    a = t_out.write_stream_output_nc(run["t"] / "s.nc", run["ids"],
                                     run["fvd"], T0, DT)
    b = j_out.write_stream_output_nc(run["j"] / "s.nc", run["ids"],
                                     run["fvd"], T0, DT)
    assert_nc_equal(a, b)


def test_chanobs_lakeout_files(run):
    rows = run["gage_rows"]
    for append in (False, True, True):   # create, create-or-append, append
        for out, base in ((t_out, run["t"]), (j_out, run["j"])):
            out.write_chanobs_nc(base / f"chanobs_{append}.nc",
                                 run["gage_ids"], run["ids"][rows],
                                 run["fvd"][:, rows], T0, DT, append=append)
        assert_nc_equal(run["t"] / f"chanobs_{append}.nc",
                        run["j"] / f"chanobs_{append}.nc")
    with h5py.File(run["t"] / "chanobs_True.nc") as f:
        assert f["streamflow"].shape == (2 * run["nts"], 3)
    lk = run["lake_rows"]
    for out, base in ((t_out, run["t"]), (j_out, run["j"])):
        out.write_lakeout_nc(base / "lake.nc", run["ids"][lk],
                             run["fvd"][11, lk, 0], run["fvd"][11, lk, 2],
                             run["fvd"][10, lk, 0], T0)
    assert_nc_equal(run["t"] / "lake.nc", run["j"] / "lake.nc")


def test_lastobs_written_by_one_read_by_the_other(run):
    times = np.array([-600.0, np.nan, -30.0])
    vals = np.array([3.5, np.nan, 12.25])
    end = T0 + pd.Timedelta(hours=2)
    a = t_out.write_lastobs_nc(run["t"] / "lo.nc", run["gage_ids"], times,
                               vals, end)
    b = j_out.write_lastobs_nc(run["j"] / "lo.nc", run["gage_ids"], times,
                               vals, end)
    assert_nc_equal(a, b)
    for got, want in zip(t_restart.read_lastobs_file(b),
                         j_restart.read_lastobs_file(a)):
        np.testing.assert_array_equal(got, want)
    gids, disch, offs = t_restart.read_lastobs_file(b)
    assert list(gids) == list(run["gage_ids"])
    np.testing.assert_array_equal(offs[[0, 2]], times[[0, 2]])
    np.testing.assert_array_equal(disch[[0, 2]], vals[[0, 2]])


def test_lite_restart_written_by_one_read_by_the_other(run):
    rng, ids = run["rng"], run["ids"]
    q0 = pd.DataFrame({"qu0": rng.uniform(0, 5, ids.size),
                       "qd0": rng.uniform(0, 5, ids.size),
                       "h0": rng.uniform(0, 2, ids.size)}, index=ids)
    wb = pd.DataFrame({"qd0": rng.uniform(0, 5, 2),
                       "h0": rng.uniform(9, 11, 2)},
                      index=ids[run["lake_rows"]])
    wa = t_restart.write_lite_restart(run["t"], T0, q0, wb)
    wb_ = j_restart.write_lite_restart(run["j"], T0, q0, wb)
    assert [p.name for p in wa] == [p.name for p in wb_] == [
        "channel_restart_202108231300", "waterbody_restart_202108231300"]
    for pa, pb in zip(wa, wb_):
        # each package reads the other's file
        pd.testing.assert_frame_equal(t_restart.read_lite_restart(pb),
                                      j_restart.read_lite_restart(pa))
    pd.testing.assert_frame_equal(
        t_restart.read_lite_restart(wb_[0])[list(q0.columns)], q0)
    for base in (run["t"] / "no_wb", run["j"] / "no_wb"):
        base.mkdir()
    assert [p.name for p in t_restart.write_lite_restart(
        run["t"] / "no_wb", T0, q0, None)] == [p.name for p in
        j_restart.write_lite_restart(run["j"] / "no_wb", T0, q0, None)]


def _write_chrtout(path, fids, rng, multi=0):
    with h5py.File(path, "w") as f:
        f["feature_id"] = fids
        shape = (multi, fids.size) if multi else (fids.size,)
        for name in ("q_lateral", "qBucket", "qSfcLatRunoff", "streamflow"):
            f[name] = rng.uniform(0, 2, shape).astype(np.float32)
        if multi:
            f["time"] = np.arange(multi, dtype=np.float64)[::-1]


def test_forcing_readers(run):
    rng, ids = run["rng"], run["ids"]
    files = []
    for k in range(3):
        files.append(run["t"] / f"20210823{14 + k}00.CHRTOUT_DOMAIN1")
        # a file that lacks some segments and holds foreign ones
        _write_chrtout(files[-1], np.concatenate([ids[5:], [5, 6]]), rng)
    for kw in ({}, {"gw_bucket_col": "absent"}):
        np.testing.assert_array_equal(
            t_forcing.read_qlat_chrtout(files, ids, **kw),
            j_forcing.read_qlat_chrtout(files, ids, **kw))
    mf = [run["t"] / f"mf{k}.nc" for k in range(2)]
    for p in mf:
        _write_chrtout(p, ids, rng, multi=3)
    np.testing.assert_array_equal(t_forcing.read_qlat_chrtout(mf, ids),
                                  j_forcing.read_qlat_chrtout(mf, ids))
    np.testing.assert_array_equal(
        t_forcing.read_qlat_wrf_hydro_mf(mf, ids, value_col="absent"),
        j_forcing.read_qlat_wrf_hydro_mf(mf, ids, value_col="absent"))
    pd.DataFrame(rng.uniform(0, 1, (ids.size - 3, 4)),
                 index=ids[3:]).to_csv(run["t"] / "ql.csv")
    got = t_forcing.read_qlat_csv(run["t"] / "ql.csv", ids)
    np.testing.assert_array_equal(
        got, j_forcing.read_qlat_csv(run["t"] / "ql.csv", ids))
    assert got.shape == (4, ids.size) and (got[:, :3] == 0).all()
    # validation flows and the parity statistics
    np.testing.assert_array_equal(
        t_parity.read_chrtout_streamflow(files, ids[:8]),
        j_parity.read_chrtout_streamflow(files, ids[:8]))
    sim, ref = rng.uniform(0, 5, (3, 8)), rng.uniform(0, 5, (3, 8))
    ref[0, 0] = np.nan
    assert t_parity.parity_check(sim, ref, label="x") == \
        j_parity.parity_check(sim, ref, label="x")
    assert t_parity.parity_check(sim[:0], ref[:0]) == {"n": 0}


def _write_timeslice(path, stamps, gages, values, quality):
    with h5py.File(path, "w") as f:
        f["stationId"] = _chars(gages)
        f["time"] = _chars(stamps, 19)
        f["discharge"] = np.asarray(values, np.float32)
        f["discharge_quality"] = np.asarray(quality, np.int16)


def test_timeslice_readers(run):
    rng = run["rng"]
    gages = ["01234567", "07654321", "0999", "5555"]
    files = []
    for k in range(5):
        when = T0 + pd.Timedelta(minutes=15 * k)
        files.append(run["t"] / (when.strftime("%Y-%m-%d_%H:%M:%S")
                                 + ".15min.usgsTimeSlice.ncdf"))
        q = rng.uniform(1, 9, 4)
        q[1] = -1.0 if k == 2 else q[1]
        _write_timeslice(files[-1], [when.strftime("%Y-%m-%d_%H:%M:%S")] * 4,
                         gages, q, [100, 100, 50 if k == 1 else 100, 100])
    files.append(run["t"] / "not_a_file.ncdf")
    pd.testing.assert_frame_equal(t_ts.read_timeslice_file(files[0]),
                                  j_ts.read_timeslice_file(files[0]))
    kw = dict(qc_threshold=1.0, interpolation_limit=59, frequency_secs=DT,
              t0=T0, nts=12)
    got = t_ts.get_obs_from_timeslices(run["gage_ids"], files, **kw)
    want = j_ts.get_obs_from_timeslices(run["gage_ids"], files, **kw)
    pd.testing.assert_frame_equal(got, want)
    assert got.shape == (3, 13) and np.isfinite(got.to_numpy()).any()
    np.testing.assert_array_equal(
        t_ts.build_obs_array(got, {}, 3, 12),
        j_ts.build_obs_array(want, {}, 3, 12))
    with pytest.raises(ValueError):
        t_ts.build_obs_array(got, {}, 2, 12)
    assert t_ts.get_obs_from_timeslices(["none"], files, **kw).empty
    # Great Lakes inputs from the same files, and the constants
    lake_gages = {4800002: "01234567", 4800004: "0999"}
    csv = run["t"] / "ontario.csv"
    csv.write_text("Date,Hour,Outflow\n2021-08-23,13:00,7000\n"
                   "2021-08-23,24:00,7100\n2021-08-24,01:00,\n")
    got = t_gl.assemble_gl_inputs(lake_gages, T0, usgs_files=files[:5],
                                  lake_ontario_csv=csv)
    want = j_gl.assemble_gl_inputs(lake_gages, T0, usgs_files=files[:5],
                                   lake_ontario_csv=csv)
    assert got.keys() == want.keys() == {4800002, 4800004, 4800007}
    for lake in got:
        for x, y in zip(got[lake], want[lake]):
            np.testing.assert_array_equal(x, y)
    for name in ("GREAT_LAKE_IDS", "GL_USGS_GAGES", "GL_CANADA_GAGES"):
        assert getattr(t_glc, name) == getattr(j_glc, name)
    assert t_rfcx.RFC_LAKE_GAGE == j_rfcx.RFC_LAKE_GAGE


def test_rfc_reader(run):
    folder = run["t"] / "rfc"
    folder.mkdir()
    stamp = (T0 + pd.Timedelta(hours=28 - 3)).strftime("%Y-%m-%d_%H")
    with h5py.File(folder / f"{stamp}.60min.ABCD1.RFCTimeSeries.ncdf",
                   "w") as f:
        f["discharges"] = run["rng"].uniform(1, 9, 30).astype(np.float32)
        f["synthetic_values"] = np.zeros(30, np.int8)
        f["totalCounts"] = np.array([30], np.int32)
        f["observedCounts"] = np.array([12], np.int32)
        f["timeSteps"] = np.array([3600], np.int32)
    got = t_rfc.preprocess_rfc_data(T0, 28, "ABCD1", folder, DT)
    want = j_rfc.preprocess_rfc_data(T0, 28, "ABCD1", folder, DT)
    assert got.keys() == want.keys() and got["use_rfc"] is True
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert t_rfc.preprocess_rfc_data(T0, 28, "NONE1", folder, DT) is None


def test_routelink_and_lakeparm_readers(tmp_path):
    from test_torch_network import write_routelink_domain
    dom = write_routelink_domain(tmp_path, n=300, n_lakes=3, n_gages=4)
    path = tmp_path / "domain" / "RouteLink.nc"
    for mask in (None, dom["ids"][::3]):
        got = t_rl.read_routelink(path, {"alt": "alt"}, mask)
        want = j_rl.read_routelink(path, {"alt": "alt"}, mask)
        for name in ("ids", "downstream", "waterbody", "alt"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))
        assert list(got.gages) == list(want.gages)
        for k in want.channel:
            np.testing.assert_array_equal(got.channel[k], want.channel[k])
    lake = tmp_path / "domain" / "LAKEPARM.nc"
    for mask in (None, set(dom["lake_ids"][:2].tolist())):
        got = t_rl.read_lakeparm(lake, "lake_id", mask)
        want = j_rl.read_lakeparm(lake, "lake_id", mask)
        np.testing.assert_array_equal(got.lake_ids, want.lake_ids)
        np.testing.assert_array_equal(got.params, want.params)


def test_append_into_existing_files(run):
    """CHRTOUT and HYDRO_RST appends: both packages add the same variables
    to copies of the same files."""
    rng, ids, fvd = run["rng"], run["ids"], run["fvd"]
    for base in (run["t"], run["j"]):
        sub = np.random.default_rng(1)
        for k in range(2):
            _write_chrtout(base / f"20210823{14 + k}00.CHRTOUT_DOMAIN1",
                           np.concatenate([ids[::2], [7]]), sub)
        with h5py.File(base / "RouteLink.nc", "w") as f:
            f["link"] = np.concatenate([ids[::-1], [3]])
        for k, stamp in enumerate(("2021-08-23_14:00:00",
                                   "2021-08-23_19:00:00")):
            with h5py.File(base / f"HYDRO_RST.{k}", "w") as f:
                f.attrs["Restart_Time"] = np.bytes_(stamp)
                f["qlink1"] = np.zeros(ids.size + 1, np.float32)
    for out, restart, base in ((t_out, t_restart, run["t"]),
                               (j_out, j_restart, run["j"])):
        w = out.append_chrtout(sorted(base.glob("*CHRTOUT*")), ids, fvd, 12)
        assert len(w) == 2
        w = restart.append_hydro_rst(sorted(base.glob("HYDRO_RST.*")), ids,
                                     fvd, T0, DT, base / "RouteLink.nc")
        assert [p.name for p in w] == ["HYDRO_RST.0"]
    for name in ("202108231400.CHRTOUT_DOMAIN1", "202108231500.CHRTOUT_DOMAIN1",
                 "HYDRO_RST.0", "HYDRO_RST.1"):
        assert_nc_equal(run["t"] / name, run["j"] / name)
    with h5py.File(run["t"] / "HYDRO_RST.0") as f:
        assert (f["qlink1_troute"][:-1] > 0).all()

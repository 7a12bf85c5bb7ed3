"""Port parity for the per-step reservoir operations: level-pool routing
(``troute_torch/ops/levelpool.py``) and reservoir DA
(``troute_torch/ops/reservoir_da.py``) against the JAX ops and the scalar
oracles, on the trajectories of ``test_levelpool.py`` and
``test_reservoir_da.py``.

Tolerances: f64 rel 1e-12 (the existing tests' bar against the oracles;
these updates are well-conditioned, so the last-ulp differences of
``sqrt``/``pow`` between libms stay at that level).  f32 rel 1e-5 per step
on the golden hydrograph, 20 ulps, against JAX's f32 trajectory.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from troute_tpu.ops import levelpool as jlp
from troute_tpu.ops import reservoir_da as jda
from troute_torch.ops import levelpool as tlp
from troute_torch.ops import reservoir_da as tda

from reference_impl import gl_da_ref, hybrid_da_ref, levelpool_ref, rfc_da_ref
from test_levelpool import (EXPECTED_FINAL_ELEVATION, EXPECTED_FINAL_OUTFLOW,
                            INFLOWS, LP, ROUTING_PERIOD)

torch.set_num_threads(1)

DT = 300.0
F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _lp_values(n=1):
    return [np.full(n, LP[k]) for k in (
        "lake_area", "max_depth", "orifice_area", "orifice_coefficient",
        "orifice_elevation", "weir_coefficient", "weir_elevation",
        "weir_length", "dam_length")]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_levelpool_golden_hydrograph(dtype):
    """The 108-step golden run (test_levelpool.py:66): reference final
    values, and every step against JAX (and the f64 oracle)."""
    np_dtype, torch_dtype = ((np.float32, torch.float32) if dtype == "f32"
                             else (np.float64, F64))
    vals = _lp_values()
    tp = tlp.LevelpoolParams(*[_t(v, torch_dtype) for v in vals])
    jp = jlp.LevelpoolParams(*[jnp.asarray(v, np_dtype) for v in vals])
    jstep = jax.jit(jlp.levelpool_step)
    H_t = _t([LP["water_elevation"]], torch_dtype)
    H_j = jnp.asarray([LP["water_elevation"]], np_dtype)
    H_ref = LP["water_elevation"]
    rtol = 1e-5 if dtype == "f32" else 1e-12
    for q in INFLOWS:
        qi = _t([q], torch_dtype)
        out_t, H_t = tlp.levelpool_step(H_t, qi, qi, torch.zeros_like(qi),
                                        ROUTING_PERIOD, tp)
        qj = jnp.asarray([q], np_dtype)
        out_j, H_j = jstep(H_j, qj, qj, jnp.zeros_like(qj), ROUTING_PERIOD,
                           jp)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=rtol)
        np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=rtol)
        if dtype == "f64":
            out_r, H_ref = levelpool_ref(
                H_ref, float(q), float(q), 0.0, ROUTING_PERIOD,
                LP["lake_area"], LP["weir_elevation"], LP["max_depth"],
                LP["weir_coefficient"], LP["weir_length"],
                LP["dam_length"], LP["orifice_elevation"],
                LP["orifice_coefficient"], LP["orifice_area"])
            assert float(out_t[0]) == pytest.approx(out_r, rel=1e-12,
                                                    abs=1e-12)
            assert float(H_t[0]) == pytest.approx(H_ref, rel=1e-12)
    assert float(out_t[0]) == pytest.approx(EXPECTED_FINAL_OUTFLOW, rel=1e-4)
    assert float(H_t[0]) == pytest.approx(EXPECTED_FINAL_ELEVATION, rel=1e-5)


def test_levelpool_branches_vs_jax():
    """Random lanes through every discharge branch (dead pool, orifice,
    weir, overtop), plus ``from_array`` and ``cold_start_elevation``."""
    rng = np.random.default_rng(12)
    n = 256
    wb = np.stack([rng.uniform(0.5, 20.0, n), rng.uniform(9.0, 11.0, n),
                   rng.uniform(0.5, 2.0, n), rng.uniform(0.05, 0.2, n),
                   rng.uniform(6.0, 8.0, n), rng.uniform(0.3, 0.5, n),
                   rng.uniform(8.5, 9.5, n), rng.uniform(5.0, 20.0, n),
                   rng.uniform(0.0, 1.0, n)], axis=1)
    tp = tlp.LevelpoolParams.from_array(wb, device="cpu", dtype=F64)
    jp = jlp.LevelpoolParams.from_array(jnp.asarray(wb))
    ifd = wb[:, 8]
    np.testing.assert_array_equal(
        tlp.cold_start_elevation(tp, _t(ifd)).numpy(),
        np.asarray(jlp.cold_start_elevation(jp, jnp.asarray(ifd))))
    H = rng.uniform(5.0, 12.0, n)
    qi0, qi1 = rng.uniform(0, 500, n), rng.uniform(0, 500, n)
    ql = rng.uniform(0, 5, n)
    out_t, H_t = tlp.levelpool_step(_t(H), _t(qi0), _t(qi1), _t(ql), DT, tp)
    out_j, H_j = jlp.levelpool_step(*[jnp.asarray(a) for a in
                                      (H, qi0, qi1, ql)], DT, jp)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(H_t.numpy(), np.asarray(H_j), rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_levelpool_wrapper_is_the_plain_version_on_cpu(dtype):
    """``ops/levelpool_cuda.py`` on CPU tensors: the lane form is the plain
    ``levelpool_step`` (``ql`` None as zeros), the row form the gather,
    the plain step with zero lateral inflow and ``index_put`` into
    ``into`` (then returning the new elevation alone), bit for bit; no
    launch is counted, by the wrapper or, under a profiler, by
    ``engine.levelpool_launches``.  The wrapper's checks raise on CPU
    tensors too."""
    from torch.profiler import ProfilerActivity, profile

    from troute_torch import tracing
    from troute_torch.ops import levelpool_cuda as lpc
    rng = np.random.default_rng(31)
    n, n_nodes = 96, 400
    wb = np.stack([rng.uniform(0.5, 20.0, n), rng.uniform(9.0, 11.0, n),
                   rng.uniform(0.5, 2.0, n), rng.uniform(0.05, 0.2, n),
                   rng.uniform(6.0, 8.0, n), rng.uniform(0.3, 0.5, n),
                   rng.uniform(8.5, 9.5, n), rng.uniform(5.0, 20.0, n),
                   rng.uniform(0.0, 1.0, n)], axis=1)
    wb[::7, 0] = 0.0
    p = tlp.LevelpoolParams.from_array(wb, device="cpu", dtype=dtype)
    H, qi0, qi1, ql = (_t(a, dtype) for a in (
        rng.uniform(5.0, 12.0, n), rng.uniform(0, 500, n),
        rng.uniform(0, 500, n), rng.uniform(0, 5, n)))
    rows = torch.as_tensor(rng.choice(n_nodes, n, replace=False))
    quc, q, d = (_t(rng.uniform(0, 500, n_nodes), dtype) for _ in range(3))
    q_in, d_in = q.clone(), d.clone()
    tracing.drain()
    before = lpc.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]):
        lanes = lpc.levelpool_step_cuda(H, qi0, qi1, ql, DT, p)
        lanes0 = lpc.levelpool_step_cuda(H, qi0, qi1, None, DT, p)
        by_rows = lpc.levelpool_rows_cuda(H, quc, rows, DT, p)
        h_into = lpc.levelpool_rows_cuda(H, quc, rows, DT, p,
                                         into=(q_in, d_in))
    assert lpc.LAUNCHES == before
    assert "engine.levelpool_launches" not in tracing.drain()[1]
    for g, w in zip(lanes, tlp.levelpool_step(H, qi0, qi1, ql, DT, p)):
        assert torch.equal(g, w)
    for g, w in zip(lanes0, tlp.levelpool_step(H, qi0, qi1,
                                                torch.zeros_like(ql), DT, p)):
        assert torch.equal(g, w)
    inflow = quc[rows]
    out, h_new = tlp.levelpool_step(H, inflow, inflow,
                                    torch.zeros_like(inflow), DT, p)
    assert len(by_rows) == 3
    for g, w in zip(by_rows, (out, h_new, inflow)):
        assert torch.equal(g, w)
    assert torch.equal(h_into, h_new)
    assert torch.equal(q_in, q.index_put((rows,), out))
    assert torch.equal(d_in, d.index_put((rows,), h_new))
    other = torch.float32 if dtype == F64 else F64
    bad = [
        lambda: lpc.levelpool_step_cuda(H, qi0.to(other), qi1, ql, DT, p),
        lambda: lpc.levelpool_step_cuda(H, qi0[1:], qi1, ql, DT, p),
        lambda: lpc.levelpool_step_cuda(H, qi0.to("meta"), qi1, ql, DT, p),
        lambda: lpc.levelpool_step_cuda(
            _t(np.zeros((n, 2)), dtype)[:, 0], qi0, qi1, ql, DT, p),
        lambda: lpc.levelpool_step_cuda(H.half(), qi0.half(), qi1.half(),
                                        None, DT, p),
        lambda: lpc.levelpool_rows_cuda(H, quc, rows.int(), DT, p),
        lambda: lpc.levelpool_rows_cuda(H, quc, rows[1:], DT, p),
        lambda: lpc.levelpool_rows_cuda(H, quc.to(other), rows, DT, p),
        lambda: lpc.levelpool_rows_cuda(H, quc, rows, DT, p,
                                        into=(q_in, q_in[:-1])),
        lambda: lpc.levelpool_rows_cuda(H, quc, rows, DT, p,
                                        into=(quc, d_in)),
    ]
    for call in bad:
        with pytest.raises((ValueError, TypeError)):
            call()


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_levelpool_params_packed_once_per_set(dtype):
    """The kernel's [n, 9] parameter matrix: packed in
    ``LevelpoolParams``' field order, from column views or separate
    tensors, kept and handed back for the same parameter set, packed anew
    after a field is written in place or for another set, and checked
    against the lakes when packed."""
    from troute_torch.ops import levelpool_cuda as lpc
    rng = np.random.default_rng(32)
    n = 40
    wb = rng.uniform(0.1, 10.0, (n, 9))
    p = tlp.LevelpoolParams.from_array(wb, device="cpu", dtype=dtype)
    H = _t(rng.uniform(5.0, 12.0, n), dtype)
    packed = lpc._packed(p, H)
    assert packed.shape == (n, 9) and packed.is_contiguous()
    for k, c in enumerate(p):
        assert torch.equal(packed[:, k], c)
    assert lpc._packed(p, H) is packed
    flat = tlp.LevelpoolParams(*[c.contiguous() for c in p])
    assert torch.equal(lpc._packed(flat, H), packed)
    p.weir_elev.add_(1.0)
    again = lpc._packed(p, H)
    assert again is not packed
    assert torch.equal(again[:, 6], p.weir_elev)
    assert lpc._packed(p, H) is again
    other = torch.float32 if dtype == F64 else F64
    for bad_h in (H[1:], H.to(other)):
        with pytest.raises(ValueError):
            lpc._packed(p, bad_h)
    with pytest.raises(ValueError):
        lpc._packed(p._replace(area=p.area[1:]), H)
    for _ in range(lpc._PACKED_KEEP + 1):
        lpc._packed(tlp.LevelpoolParams(*[c.clone() for c in p]), H)
    assert len(lpc._PACKED) <= lpc._PACKED_KEEP


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_levelpool_da_wrapper_is_the_plain_version_on_cpu(dtype):
    """The DA form of ``ops/levelpool_cuda.py`` on CPU tensors, on lakes
    that take every branch of each DA kind (``reservoir_da_lanes``): the
    lane form is the plain level pool (inflow as both ``qi0`` and ``qi1``,
    no lateral inflow) then ``typed_reservoir_dispatch``, the row form the
    same at ``quc[rows]`` with ``index_put`` of the outflow and the depth
    column into ``into``, bit for bit (NaN where NaN); the caller's states
    are not written, and no launch is counted, by the wrapper or, under a
    profiler, by ``engine.levelpool_launches`` or
    ``engine.reservoir_da_launches``."""
    from torch.profiler import ProfilerActivity, profile

    import reservoir_da_lanes as rdl
    from troute_torch import tracing
    from troute_torch.ops import levelpool_cuda as lpc
    x = rdl.da_lanes(dtype, "cpu", per_branch=4, seed=7)
    H, inflow, p, rd, st = (x[k] for k in ("H", "inflow", "p", "res_da",
                                          "states"))
    now, month = x["now"], x["month_i"]
    kept = [[f.clone() for f in s] for s in st]
    n = H.shape[0]
    rng = np.random.default_rng(33)
    rows = torch.as_tensor(rng.choice(3 * n, n, replace=False))
    quc = _t(rng.uniform(0, 500, 3 * n), dtype).index_put((rows,), inflow)
    q, d = (_t(rng.uniform(0, 500, 3 * n), dtype) for _ in range(2))
    q_in, d_in = q.clone(), d.clone()
    tracing.drain()
    before = (lpc.LAUNCHES, lpc.DA_LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]):
        lanes = lpc.levelpool_da_step_cuda(H, inflow, DT, p, rd, st, now,
                                           month)
        by_rows = lpc.levelpool_da_rows_cuda(H, quc, rows, DT, p, rd, st,
                                             now, month, into=(q_in, d_in))
    assert (lpc.LAUNCHES, lpc.DA_LAUNCHES) == before
    counts = tracing.drain()[1]
    assert "engine.levelpool_launches" not in counts
    assert "engine.reservoir_da_launches" not in counts
    lp_out, lp_elev = tlp.levelpool_step(H, inflow, inflow,
                                         torch.zeros_like(inflow), DT, p)
    out, elev, d_scat, *states = rdl.plain_dispatch(
        rd, st, H, inflow, lp_out, lp_elev, now, month, p, DT)
    for g, w in zip(lanes[:3], (out, elev, d_scat)):
        assert rdl.same(g, w)
    assert rdl.same(by_rows[0], elev)
    assert rdl.same(q_in, q.index_put((rows,), out))
    assert rdl.same(d_in, d.index_put((rows,), d_scat))
    for got in (lanes[3], by_rows[1]):
        for gs, ws in zip(got, states):
            for g, w in zip(gs, ws):
                assert rdl.same(g, w)
    for s, k in zip(st, kept):
        for f, c in zip(s, k):
            assert rdl.same(f, c)
    # each kind moved its own state
    wt = rd.wbody_type
    hyb, rfc, gl = lanes[3]
    assert not torch.equal(hyb.update_time[wt == 2],
                           st[0].update_time[wt == 2])
    assert not torch.equal(rfc.timeseries_idx[wt == 4],
                           st[1].timeseries_idx[wt == 4])
    assert not torch.equal(gl.update_time[wt == 6],
                           st[2].update_time[wt == 6])
    with pytest.raises(ValueError):
        lpc.levelpool_da_rows_cuda(H, quc, rows, DT, p, rd, st, now, month,
                                   into=None)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_levelpool_da_inputs_packed_once_per_data(dtype):
    """What the DA form hands the kernel, on CPU tensors: the DA inputs'
    pointers, strides and counts (the struct ``csrc/levelpool.cu`` reads),
    packed once per DA data object and again after an in-place write or
    for other lakes; integer types and flags of another width converted;
    the state fields' pointers in the kernel's order, the caller's tensors
    untouched; the month as Python indexes it; and the checks that raise
    before any launch."""
    import reservoir_da_lanes as rdl
    from troute_torch.ops import levelpool_cuda as lpc
    x = rdl.da_lanes(dtype, "cpu", per_branch=2, seed=8)
    H, rd, st = x["H"], x["res_da"], x["states"]
    da, months = lpc._da_packed(rd, H)
    assert months == 12 and da.n_hobs == rdl.N_HOBS
    assert da.n_counts == rdl.N_COUNTS and da.n_gobs == rdl.N_GOBS
    assert da.wbody_type == rd.wbody_type.data_ptr()
    assert da.hyb_obs == rd.hybrid_obs.data_ptr()
    assert (da.hyb_obs_s0, da.hyb_obs_s1) == rd.hybrid_obs.stride()
    assert (da.gl_time_s0, da.gl_time_s1) == rd.gl_obs_time.stride()
    assert da.lookback_s == rd.obs_lookback_hours * 3600.0
    assert lpc._da_packed(rd, H)[0] is da
    rd.rfc_series.mul_(2.0)
    again = lpc._da_packed(rd, H)[0]
    assert again is not da and again.rfc_series == rd.rfc_series.data_ptr()
    # a column view of a wider matrix keeps its strides
    wide = torch.cat([rd.hybrid_obs, rd.hybrid_obs], dim=1)[:, ::2]
    view = lpc._da_packed(rd._replace(hybrid_obs=wide), H)[0]
    assert (view.hyb_obs, view.hyb_obs_s0, view.hyb_obs_s1) == (
        wide.data_ptr(), 2 * rdl.N_HOBS, 2)
    wide64 = rd._replace(wbody_type=rd.wbody_type.long(),
                         rfc_use=rd.rfc_use.to(torch.uint8))
    t = lpc._da_tensors(wide64, H)
    assert t["wbody_type"].dtype == torch.int32
    assert torch.equal(t["wbody_type"], rd.wbody_type)
    assert t["rfc_use"].dtype == torch.bool
    assert torch.equal(t["rfc_use"], rd.rfc_use)
    other = torch.float32 if dtype == F64 else F64
    bad_da = [
        rd._replace(wbody_type=rd.wbody_type.to(dtype)),
        rd._replace(rfc_counts=rd.rfc_counts[1:]),
        rd._replace(rfc_timestep=rd.rfc_timestep.to(other)),
        rd._replace(hybrid_obs=rd.hybrid_obs[:, :0],
                    hybrid_obs_time=rd.hybrid_obs_time[:0]),
        rd._replace(hybrid_obs_time=rd.hybrid_obs_time[1:]),
        rd._replace(rfc_series=rd.rfc_series.to(other)),
        rd._replace(gl_obs=rd.gl_obs[:, :0],
                    gl_obs_time=rd.gl_obs_time[:, :0]),
        rd._replace(gl_obs_time=rd.gl_obs_time[:, 1:]),
        rd._replace(gl_climatology=rd.gl_climatology[1:]),
    ]
    for bad in bad_da:
        with pytest.raises(ValueError):
            lpc._da_packed(bad, H)
    with pytest.raises(ValueError):
        lpc._da_packed(rd, H[1:])
    # only the data packed last is kept: the one before is freed
    hour = rd._replace(hybrid_obs=rd.hybrid_obs.clone())
    lpc._da_packed(hour, H)
    freed = weakref.ref(hour.hybrid_obs)
    del hour
    lpc._da_packed(rd, H)
    gc.collect()
    assert freed() is None

    assert [lpc._month(m, 12) for m in (0, 4, 11, -1, -12)] == [0, 4, 11, 11,
                                                                0]
    for m in (12, -13):
        with pytest.raises(IndexError):
            lpc._month(m, 12)

    hyb, rfc, gl = st
    ptrs, keep = lpc._state_ptrs(st, H)
    assert ptrs == [a.data_ptr() for a in (*hyb, rfc.timeseries_idx,
                                           rfc.update_time, *gl)]
    idx64 = rfc.timeseries_idx.long()
    strided = torch.stack([hyb.update_time, hyb.update_time], dim=1)[:, 0]
    ptrs, keep = lpc._state_ptrs(
        (hyb._replace(update_time=strided), rfc._replace(timeseries_idx=idx64),
         gl), H)
    assert keep[4].dtype == torch.int32 and torch.equal(keep[4], idx64.int())
    assert keep[1].is_contiguous() and torch.equal(keep[1], strided)
    assert idx64.dtype == torch.int64 and not strided.is_contiguous()
    for bad in ((hyb._replace(update_time=hyb.update_time[1:]), rfc, gl),
                (hyb, rfc._replace(timeseries_idx=rfc.update_time), gl),
                (hyb, rfc, gl._replace(update_time=gl.update_time.to(other)))):
        with pytest.raises(ValueError):
            lpc._state_ptrs(bad, H)


def _hybrid_obs(rng, n_lanes, n_obs):
    obs = rng.uniform(5, 50, (n_lanes, n_obs))
    obs[0, 10:18] = np.nan          # data gap
    obs[0, 30:] = np.nan            # obs end early -> persistence
    obs[1, :] = np.nan              # no obs at all
    obs[2, 5:] = np.nan
    return obs


def test_hybrid_da_trajectory_vs_jax_and_oracle():
    rng = np.random.default_rng(9)
    n_lanes, n_obs = 3, 40
    obs_time = np.arange(n_obs) * 900.0
    obs = _hybrid_obs(rng, n_lanes, n_obs)
    init = dict(persisted_outflow=np.array([np.nan, 20.0, np.nan]),
                update_time=np.zeros(n_lanes),
                persistence_index=np.array([0.0, 12.0, 0.0]),
                persistence_update_time=np.zeros(n_lanes))
    st_t = tda.HybridDAState(**{k: _t(v) for k, v in init.items()})
    st_j = jda.HybridDAState(**{k: jnp.asarray(v) for k, v in init.items()})
    s_prev, s_ut, s_pidx, s_put = np.nan, 0.0, 0.0, 0.0
    area, max_depth, oe = 15.0, 9.96, 7.733
    ones = np.ones(n_lanes)
    elev_t = elev_j = 9.7 * ones
    elev_s = 9.7
    fn = jax.jit(jda.hybrid_persistence_da,
                 static_argnames=("obs_lookback_hours",))
    for t in range(1, 241):
        now = t * DT
        lp_out, inflow = 10.0 + 0.01 * t, 12.0 + 0.05 * t
        out_t, elev_tn, st_t = tda.hybrid_persistence_da(
            st_t, _t(obs), _t(obs_time), now, _t(lp_out * ones),
            _t(inflow * ones), DT, _t(area * ones), _t(max_depth * ones),
            _t(oe * ones), _t(elev_t), obs_lookback_hours=48.0)
        out_j, elev_jn, st_j = fn(
            st_j, jnp.asarray(obs), jnp.asarray(obs_time), now,
            jnp.asarray(lp_out * ones), jnp.asarray(inflow * ones), DT,
            jnp.asarray(area * ones), jnp.asarray(max_depth * ones),
            jnp.asarray(oe * ones), jnp.asarray(elev_j),
            obs_lookback_hours=48.0)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   rtol=1e-12, atol=1e-12, err_msg=str(t))
        np.testing.assert_allclose(elev_tn.numpy(), np.asarray(elev_jn),
                                   rtol=1e-12, err_msg=str(t))
        for a, b in zip(st_t, st_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       err_msg=str(t))
        out_s, s_prev, elev_sn, s_ut, s_pidx, s_put = hybrid_da_ref(
            obs[0], obs_time, now, s_prev, s_put, s_pidx, lp_out, inflow,
            DT, area, max_depth, oe, elev_s, 48.0, s_ut)
        assert float(out_t[0]) == pytest.approx(out_s, rel=1e-12, abs=1e-12)
        assert float(elev_tn[0]) == pytest.approx(elev_sn, rel=1e-12)
        elev_t, elev_j, elev_s = elev_tn.numpy(), np.asarray(elev_jn), elev_sn


@pytest.mark.parametrize("rtype", [4, 5])
def test_rfc_da_trajectory_vs_jax_and_oracle(rtype):
    rng = np.random.default_rng(3)
    n_counts = 30
    series = rng.uniform(10, 100, n_counts)
    series[7] = -5.0    # bad value -> backstop walks back
    series[0:2] = -1.0  # early negatives
    st_t = tda.RfcDAState(torch.tensor([3], dtype=torch.int32), _t([0.0]))
    st_j = jda.RfcDAState(jnp.asarray([3], jnp.int32), jnp.asarray([0.0]))
    s_idx, s_ut = 3, 0.0
    elev_t = elev_j = elev_s = 8.0
    area_m2, lp_out, lp_elev = 15.0e6, 15.0, 7.9
    fixed = dict(series=[series], counts=[n_counts], use=[True],
                 step=[3600.0], persist=[11 * 86400.0], rtype=[rtype],
                 lp_out=[lp_out], lp_elev=[lp_elev], area=[area_m2],
                 maxe=[9.96])
    ints = ("counts", "rtype")
    tin = {k: (torch.tensor(v, dtype=torch.int32) if k in ints
               else torch.tensor(v) if k == "use" else _t(v))
           for k, v in fixed.items()}
    jin = {k: (jnp.asarray(v, jnp.int32) if k in ints else jnp.asarray(v))
           for k, v in fixed.items()}
    fn = jax.jit(jda.rfc_forecast_da)
    for t in range(1, 100):
        now = t * DT
        inflow = 20.0 + t * 0.1
        out_t, elev_tn, st_t = tda.rfc_forecast_da(
            st_t, tin["series"], tin["counts"], tin["use"], tin["step"],
            tin["persist"], tin["rtype"], now, _t([inflow]), _t([elev_t]),
            tin["lp_out"], tin["lp_elev"], tin["area"], tin["maxe"], DT)
        out_j, elev_jn, st_j = fn(
            st_j, jin["series"], jin["counts"], jin["use"], jin["step"],
            jin["persist"], jin["rtype"], now, jnp.asarray([inflow]),
            jnp.asarray([elev_j]), jin["lp_out"], jin["lp_elev"],
            jin["area"], jin["maxe"], DT)
        assert float(out_t[0]) == pytest.approx(float(out_j[0]), rel=1e-12)
        assert float(elev_tn[0]) == pytest.approx(float(elev_jn[0]),
                                                  rel=1e-12)
        assert st_t.timeseries_idx.dtype == torch.int32
        assert int(st_t.timeseries_idx[0]) == int(st_j.timeseries_idx[0])
        assert float(st_t.update_time[0]) == float(st_j.update_time[0])
        out_s, elev_sn, s_ut, s_idx = rfc_da_ref(
            True, series, s_idx, n_counts, DT, now, s_ut, 3600.0,
            11 * 86400.0, rtype, inflow, elev_s, lp_out, lp_elev, area_m2,
            9.96)
        assert float(out_t[0]) == pytest.approx(out_s, rel=1e-12)
        assert float(elev_tn[0]) == pytest.approx(elev_sn, rel=1e-12)
        assert int(st_t.timeseries_idx[0]) == s_idx
        elev_t, elev_j, elev_s = float(elev_tn[0]), float(elev_jn[0]), elev_sn


def test_gl_da_trajectory_vs_jax_and_oracle():
    rng = np.random.default_rng(4)
    n_obs = 20
    obs_time = np.arange(n_obs) * 3600.0
    obs = rng.uniform(100, 200, n_obs)
    obs[5:9] = np.nan
    clim = rng.uniform(50, 150, 12)
    init = [np.array([np.nan]), np.array([0.0]), np.array([0.0])]
    st_t = tda.GreatLakesDAState(*[_t(v) for v in init])
    st_j = jda.GreatLakesDAState(*[jnp.asarray(v) for v in init])
    s_out, s_time, s_ut = np.nan, 0.0, 0.0
    fn = jax.jit(jda.great_lakes_da)
    for t in range(1, 200):
        now, month = t * DT, 5
        out_t, st_t = tda.great_lakes_da(st_t, _t([obs]), _t([obs_time]), now,
                                         month, _t([clim]))
        out_j, st_j = fn(st_j, jnp.asarray([obs]), jnp.asarray([obs_time]),
                         now, month, jnp.asarray([clim]))
        assert float(out_t[0]) == pytest.approx(float(out_j[0]), rel=1e-12)
        for a, b in zip(st_t, st_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)
        out_s, s_out, s_time, s_ut = gl_da_ref(
            obs, obs_time, s_out, s_time, s_ut, now, month, clim)
        assert float(out_t[0]) == pytest.approx(out_s, rel=1e-12)


def test_typed_reservoir_dispatch_vs_jax():
    """Six lanes, one per reservoir type (1..6), over 120 steps: outflow,
    elevations and all three DA states against JAX."""
    rng = np.random.default_rng(21)
    n, n_hobs, n_cnt, n_gobs = 6, 40, 30, 20
    wt = np.array([1, 2, 3, 4, 5, 6], np.int32)
    hobs = _hybrid_obs(rng, n, n_hobs)
    hobs_time = np.arange(n_hobs) * 900.0
    series = rng.uniform(-5, 100, (n, n_cnt))
    gobs = rng.uniform(100, 200, (n, n_gobs))
    gobs[:, 5:9] = np.nan
    gobs_time = np.tile(np.arange(n_gobs) * 3600.0, (n, 1))
    static = dict(
        wt=wt, hobs=hobs, hobs_time=hobs_time, series=series,
        counts=np.full(n, n_cnt, np.int32), use=np.ones(n, bool),
        step=np.full(n, 3600.0), persist=np.full(n, 11 * 86400.0),
        gobs=gobs, gobs_time=gobs_time, clim=rng.uniform(50, 150, (n, 12)),
        area=rng.uniform(1, 20, n), maxd=rng.uniform(9, 11, n),
        oe=rng.uniform(6, 8, n))
    tin = {k: torch.as_tensor(v) for k, v in static.items()}
    jin = {k: jnp.asarray(v) for k, v in static.items()}
    hyb0 = [np.full(n, np.nan), np.zeros(n), np.zeros(n), np.zeros(n)]
    gl0 = [np.full(n, np.nan), np.zeros(n), np.zeros(n)]
    st_t = (tda.HybridDAState(*[_t(v) for v in hyb0]),
            tda.RfcDAState(torch.full((n,), 2, dtype=torch.int32),
                           _t(np.zeros(n))),
            tda.GreatLakesDAState(*[_t(v) for v in gl0]))
    st_j = (jda.HybridDAState(*[jnp.asarray(v) for v in hyb0]),
            jda.RfcDAState(jnp.full((n,), 2, jnp.int32),
                           jnp.asarray(np.zeros(n))),
            jda.GreatLakesDAState(*[jnp.asarray(v) for v in gl0]))
    elev_t = elev_j = rng.uniform(8.0, 10.0, n)
    fn = jax.jit(jda.typed_reservoir_dispatch,
                 static_argnames=("obs_lookback_hours",))

    def call(mod, d, st, elev, inflow, lp_out, lp_elev, now, month, arr):
        return mod.typed_reservoir_dispatch(
            d["wt"], d["hobs"], d["hobs_time"], st[0], d["series"],
            d["counts"], d["use"], d["step"], d["persist"], st[1],
            d["gobs"], d["gobs_time"], d["clim"], st[2], 48.0, arr(elev),
            arr(inflow), arr(lp_out), arr(lp_elev), now, month, d["area"],
            d["maxd"], d["oe"], DT)

    jmod = type("J", (), {"typed_reservoir_dispatch": staticmethod(fn)})
    for t in range(1, 121):
        now, month = t * DT, (t // 40) % 12
        inflow = rng.uniform(5, 60, n)
        lp_out, lp_elev = rng.uniform(5, 50, n), rng.uniform(8, 10, n)
        out_t = call(tda, tin, st_t, elev_t, inflow, lp_out, lp_elev, now,
                     month, _t)
        out_j = call(jmod, jin, st_j, elev_j, inflow, lp_out, lp_elev, now,
                     month, jnp.asarray)
        for a, b in zip(out_t[:3], out_j[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                       atol=1e-12, err_msg=str(t))
        for s_t, s_j in zip(out_t[3:], out_j[3:]):
            for a, b in zip(s_t, s_j):
                assert a.numpy().dtype == np.asarray(b).dtype
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-12, err_msg=str(t))
        st_t, st_j = out_t[3:], out_j[3:]
        elev_t, elev_j = out_t[1].numpy(), np.asarray(out_j[1])

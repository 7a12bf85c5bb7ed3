"""Port parity for the block-skip MC solve and the strict options that use
it (``troute_torch/ops/muskingum_cuda.py``, ``ops/muskingum.py:
solve_block_skip``, ``routing/engine.py`` strict sweeps).

On the CPU the wrapper runs the plain version of kernel B2, so these tests
pin its semantics; ``tests/test_torch_cuda.py`` holds the kernel to it on
the card.  Both sides get the same NumPy inputs from a seed; the JAX side
runs its Pallas kernels in interpret mode, as the JAX tests do.

Tolerances:
- skip semantics: exact (an inactive block copies ``prev``; an active
  block is the plain solve, lane for lane);
- the ck/cn comparison with JAX, f64: solved lanes rtol 1e-9, atol 1e-12
  (the reference's per-lane bar), passed-through lanes exact;
- strict runs in f32 on the 4096-segment hop network: rtol 1e-4, atol
  1e-4, the JAX package's own bar for two trajectories of the strict
  iteration (``test_stepped.py:400-402``): the iterates stop at points
  that differ inside the convergence band 4 eps max|q| (and the port's
  256-lane skip blocks differ from JAX's 2048-lane ones).  Flows meet it
  everywhere.  Between the port and JAX, depth and velocity meet it on all
  but at most 1e-3 of the values, which stay within the f32 bar's 5e-2:
  measured, 4 of 49,152 values (3 lanes at step 2, up to 0.6%) in all four
  configurations alike, an f32 secant path flip (the secant stops at a 1%
  relative step) from the last-ulp difference of ``pow`` between XLA's
  and PyTorch's CPU math.  Port against port, every value meets it;
- the accelerator's gain after a skip sweep: the port's equals its gain
  before it exactly; the first sweep's analytic gain, port against JAX in
  f32, atol 1e-6 (ck and X from two libm ``pow``).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from troute_tpu.network.topology import build_topology
from troute_tpu.ops.levelpool import LevelpoolParams as JLevelpoolParams
from troute_tpu.ops.muskingum import MCOutput as JMCOutput
from troute_tpu.ops.muskingum_pallas import LANE, DEFAULT_SUBLANES
from troute_tpu.ops.muskingum_pallas import muskingum_cunge_pallas
from troute_tpu.routing import engine as jeng
from troute_torch import convert
from troute_torch.ops import muskingum_cuda as mcc
from troute_torch.ops.muskingum import MCOutput, solve_block
from troute_torch.routing import engine as teng

torch.set_num_threads(1)

DT = 300.0
SKIP = mcc.SKIP_BLOCK


def _mc_inputs(n, seed, np_dtype):
    rng = np.random.default_rng(seed)

    def a(lo, hi):
        return rng.uniform(lo, hi, n).astype(np_dtype)

    return [a(0, 5), a(0, 5), a(0, 5), a(0.01, 1), a(500, 3000), a(2, 20),
            a(25, 60), a(80, 200), np.full(n, 0.055, np_dtype),
            np.full(n, 0.11, np_dtype), a(0.3, 1.5), a(0.001, 0.02),
            a(0.05, 0.8)]


def _prev_of(full):
    """A ``prev`` distinct from the solution in every output, so a
    pass-through shows."""
    return MCOutput(*[o + 7.0 + k for k, o in enumerate(full)])


@pytest.mark.parametrize("diagnostics", [True, False])
def test_skip_semantics(diagnostics):
    """Mirrors ``test_stepped.py:315-349`` on the port's 256-lane blocks,
    with a partial last block: inactive blocks write ``prev`` through
    exactly, active blocks equal ``solve_block``, one moved lane activates
    its whole block."""
    n = 3 * SKIP + 100
    args = [torch.as_tensor(a) for a in _mc_inputs(n, 7, np.float32)]
    full = MCOutput(*solve_block(*args, dt=DT))
    prev = _prev_of(full)
    n_out = 6 if diagnostics else 3
    active = torch.zeros(n, dtype=torch.bool)
    active[SKIP + 3] = True                 # block 1 of 0..3
    active[3 * SKIP + 99] = True            # the partial last block
    out = mcc.muskingum_cunge_cuda(*args, DT, with_diagnostics=diagnostics,
                                   active_rows=active, prev=prev)
    ran = np.zeros(n, bool)
    ran[SKIP:2 * SKIP] = ran[3 * SKIP:] = True
    for k in range(n_out):
        got = out[k].numpy()
        np.testing.assert_array_equal(got[ran], full[k].numpy()[ran])
        np.testing.assert_array_equal(got[~ran], prev[k].numpy()[~ran])
    for k in range(n_out, 6):
        assert not out[k].any()
    # a single moved lane of block 0 activates all of it
    active[5] = True
    out1 = mcc.muskingum_cunge_cuda(*args, DT, with_diagnostics=diagnostics,
                                    active_rows=active, prev=prev)
    np.testing.assert_array_equal(out1.qdc[:SKIP].numpy(),
                                  full.qdc[:SKIP].numpy())
    np.testing.assert_array_equal(out1.qdc[2 * SKIP:3 * SKIP].numpy(),
                                  prev.qdc[2 * SKIP:3 * SKIP].numpy())


def test_block_active_lanes_matches_numpy():
    rng = np.random.default_rng(3)
    for n in (1, SKIP, SKIP + 1, 5 * SKIP - 7):
        act = rng.random(n) < 0.002
        want = np.zeros(n, bool)
        for b in range(0, n, SKIP):
            want[b:b + SKIP] = act[b:b + SKIP].any()
        got = mcc.block_active_lanes(torch.as_tensor(act)).numpy()
        np.testing.assert_array_equal(got, want)
        flags = mcc.block_flags(torch.as_tensor(act)).numpy()
        assert flags.shape == (-(-n // SKIP),)


def test_skip_wrapper_checks():
    args = [torch.as_tensor(a) for a in _mc_inputs(10, 1, np.float64)]
    prev = MCOutput(*solve_block(*args, dt=DT))
    with pytest.raises(ValueError):
        mcc.muskingum_cunge_cuda(*args, DT, prev=prev)
    with pytest.raises(ValueError):
        mcc.muskingum_cunge_cuda(*args, DT,
                                 active_rows=torch.ones(10, dtype=torch.bool))
    with pytest.raises(ValueError):
        mcc.muskingum_cunge_cuda(*args, DT, active_rows=torch.ones(10),
                                 prev=prev)


def test_skip_ck_cn_order_vs_jax():
    """The JAX wrapper hands ``prev`` to its skip kernel as (qdc, velc,
    depthc, cn, ck, X) (``muskingum_pallas.py:172-173``), so a skipped
    block returns ck and cn swapped; the port keeps the output order.
    Two JAX blocks of 2048 lanes, the second skipped whole; the port's
    256-lane blocks then skip the same lanes."""
    blk = DEFAULT_SUBLANES * LANE
    n = 2 * blk
    inputs = _mc_inputs(n, 11, np.float64)
    full_j = muskingum_cunge_pallas(*[jnp.asarray(a) for a in inputs], DT)
    # the same prev on both sides: JAX's solution shifted per output
    prev_np = [np.asarray(o) + 7.0 + k for k, o in enumerate(full_j)]
    act = np.zeros(n, bool)
    act[:blk] = True
    out_j = muskingum_cunge_pallas(
        *[jnp.asarray(a) for a in inputs], DT, active_rows=jnp.asarray(act),
        prev=JMCOutput(*[jnp.asarray(p) for p in prev_np]))
    out_t = mcc.muskingum_cunge_cuda(
        *[torch.as_tensor(a) for a in inputs], DT,
        active_rows=torch.as_tensor(act),
        prev=MCOutput(*[torch.as_tensor(p) for p in prev_np]))
    got = [o.numpy() for o in out_t]
    want = [np.asarray(o) for o in out_j]
    on, off = slice(0, blk), slice(blk, n)
    for k in range(6):
        np.testing.assert_allclose(got[k][on], want[k][on], rtol=1e-9,
                                   atol=1e-12)
    # the fault, shown: JAX's skipped ck is prev's cn, and its cn prev's ck
    assert np.array_equal(want[3][off], prev_np[4][off])
    assert not np.array_equal(want[3][off], prev_np[3][off])
    # the port writes prev through in output order
    np.testing.assert_array_equal(got[3][off], prev_np[3][off])
    np.testing.assert_array_equal(got[4][off], prev_np[4][off])
    # so the port's skipped ck is JAX's skipped cn, and the rest agree
    np.testing.assert_array_equal(got[3][off], want[4][off])
    np.testing.assert_array_equal(got[4][off], want[3][off])
    for k in (0, 1, 2, 5):
        np.testing.assert_array_equal(got[k][off], want[k][off])


def assert_strict_f32(got, want, what=""):
    """The docstring's f32 bar for a strict run, port against JAX."""
    np.testing.assert_allclose(got[..., 0], want[..., 0], rtol=1e-4,
                               atol=1e-4, err_msg=what)
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-4)
    assert off.sum() <= 1e-3 * off.size, (what, int(off.sum()))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert rel.max() <= 5e-2, (what, float(rel.max()))


@functools.lru_cache(maxsize=1)
def _hop_case():
    """``test_stepped.py:257-312``: a 4096-segment junction-rich forest
    (each node drains 1-4 rows down), f32, warmed by 12 short steps of
    the JAX driver; the warm state goes to both sides."""
    rng = np.random.default_rng(4)
    n = 4096
    ids = np.arange(1, n + 1, dtype=np.int64)
    idx = np.arange(n)
    down = ids[np.minimum(idx + rng.integers(1, 5, n), n - 1)]
    down[idx == n - 1] = 0
    topo = build_topology(ids, down)
    jnet = jeng.network_arrays_from_topology(topo, need_levels=False)
    assert jnet.uplan is not None
    f32 = jnp.float32
    chan = dict(dx=rng.uniform(500, 3000, n), bw=rng.uniform(2, 20, n),
                tw=rng.uniform(25, 60, n), twcc=rng.uniform(80, 200, n),
                n=np.full(n, 0.055), ncc=np.full(n, 0.11),
                cs=rng.uniform(0.3, 1.5, n), s0=rng.uniform(0.001, 0.02, n))
    jchan = jeng.ChannelParams(**{k: jnp.asarray(v, f32)
                                  for k, v in chan.items()})
    jlp = JLevelpoolParams(*[jnp.ones((1,), f32)] * 9)
    q0 = jnp.asarray(rng.uniform(0.5, 5.0, n), f32)
    d0 = jnp.asarray(rng.uniform(0.05, 0.8, n), f32)
    qlat = jnp.asarray(rng.uniform(0.1, 2.0, (2, n)), f32)
    z1 = jnp.zeros((1,), f32)
    cfg_w = jeng.RoutingConfig(dt=DT, nts=12, qts_subdivisions=6,
                               assume_short_ts=True, kernel="pallas")
    st = jeng.route_stepped(jnet, jchan, jlp, cfg_w, q0, d0, z1, qlat, None,
                            collect=False)["state"]
    return jnet, jchan, jlp, [st.q, st.depth, z1, qlat]


def test_strict_accel_and_skip_f32_vs_jax():
    """Strict ``route_stepped`` in f32 with the accelerator on and off and
    the block skip on and off, each against the JAX driver in the same
    configuration; the accelerator spends at most 0.75 of the plain
    sweeps (``test_stepped.py:257-312,352-403``)."""
    jnet, jchan, jlp, arrs = _hop_case()
    kw = dict(device="cpu", dtype=torch.float32)
    net = convert.from_network_arrays(jnet, device="cpu")
    chan = convert.from_channel_params(jchan, **kw)
    lp = convert.from_levelpool_params(jlp, **kw)
    t_arrs = [convert._t(a, **kw) for a in arrs]
    base = dict(dt=DT, nts=4, qts_subdivisions=2, assume_short_ts=False,
                strict_iterative=True, kernel="pallas")
    sweeps, fvd = {}, {}
    for accel, skip in ((False, False), (True, False), (True, True),
                        (False, True)):
        cfg = jeng.RoutingConfig(**base, strict_accel=accel,
                                 strict_block_skip=skip)
        out_j = jeng.route_stepped(jnet, jchan, jlp, cfg, *arrs, None)
        out_t = teng.route_stepped(net, chan, lp, cfg, *t_arrs)
        got = out_t["flowveldepth"].numpy()
        assert np.isfinite(got).all()
        assert_strict_f32(got, np.asarray(out_j["flowveldepth"]),
                          f"accel={accel} skip={skip}")
        assert out_t["strict_sweeps"] == out_j["strict_sweeps"]
        calls = out_t["strict_mc_calls"]
        assert sum(calls.values()) == sum(out_t["strict_sweeps"])
        # the first chunk of a run never skips; later chunks do
        assert (calls["mc_secant_skip"] > 0) == skip
        sweeps[accel, skip] = sum(out_t["strict_sweeps"])
        fvd[accel, skip] = got
    for key in fvd:
        np.testing.assert_allclose(fvd[key], fvd[False, False], rtol=1e-4,
                                   atol=1e-4, err_msg=str(key))
    assert sweeps[True, False] <= 0.75 * sweeps[False, False], sweeps


def test_skip_sweep_keeps_the_measured_gain_unlike_jax():
    """A skip sweep in which every block passes through (``skip_tol`` =
    inf) holds each lane's output while the accelerator's jump moved its
    drive.  The JAX kernel pairs the held output with the new drive, so its
    measured gain is 0 on every lane whose drive moved (``engine.py:1093``)
    and the next step starts from it; the port pairs the output with the
    drive it was solved at and keeps the last gain: its gain after the
    skip sweep equals its gain after the sweep before, lane for lane."""
    jnet, jchan, jlp, (q, d, res_elev, qlat) = _hop_case()
    kw = dict(device="cpu", dtype=torch.float32)
    net = convert.from_network_arrays(jnet, device="cpu")
    chan = convert.from_channel_params(jchan, **kw)
    lp = convert.from_levelpool_params(jlp, **kw)
    e_t, e_j = torch.zeros(0), jnp.zeros((0,), jnp.float32)
    g_t, g_j = torch.zeros(0, dtype=torch.int64), jnp.zeros((0,), jnp.int32)
    t_q, t_d, t_ql = (convert._t(a, **kw) for a in (q, d, qlat[0]))

    def port(n, skip_tol):
        return teng._strict_sweeps(
            t_q, t_q, t_d, convert._t(res_elev, **kw), e_t, e_t, t_ql, e_t,
            DT, net.upstream, chan, lp, net.is_reservoir, net.res_rows, g_t,
            120.0, DT, n, uplan=net.uplan, accel_lin=8,
            skip_tol=skip_tol)[11].numpy()

    def jax(n, skip_tol):
        return np.asarray(jeng._strict_sweep_kernel(
            q, q, d, res_elev, e_j, e_j, qlat[0], e_j,
            jnp.asarray(DT, jnp.float32), jnet.upstream, jchan, jlp,
            jnet.is_reservoir, jnet.res_rows, g_j, 120.0, DT, n,
            uplan=jnet.uplan, accel_lin=8,
            skip_tol=skip_tol and jnp.asarray(skip_tol, jnp.float32))[11])

    # the first sweep's analytic gain from two f32 solves (XLA's and
    # PyTorch's pow): equal to 1e-6
    before_t, before_j = port(2, None), jax(2, None)
    np.testing.assert_allclose(before_t, before_j, rtol=0, atol=1e-6)
    after_t, after_j = port(3, float("inf")), jax(3, float("inf"))
    np.testing.assert_array_equal(after_t, before_t)
    # JAX: 0 on the lanes whose drive moved (2,784 of 4,096; on the
    # others the drive did not move resolvably, and the analytic gain
    # stands)
    zero = after_j == 0.0
    assert zero.mean() > 0.5, float(zero.mean())
    assert not (before_j[zero] == 0.0).any()
    assert not (after_t[zero] == 0.0).any()

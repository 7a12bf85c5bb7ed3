"""The port's sharded strict fixed-point routing
(``parallel/stepped_engine.py:route_sharded_strict_stepped``, through
``route_sharded_global`` and on JAX's sharded inputs) in gloo groups of 1,
2 and 4 CPU ranks, against the JAX package's strict sharded drivers and
``route()``, and the port's single-device strict ``route_stepped``.

One spawn of 4 ranks runs every case.  Both sides stop on a tolerance, so
the bars are the JAX package's own:
* against JAX's host-stepped strict driver, and against its in-scan
  strict ``route_sharded``: rtol 2e-7, atol 1e-7
  (``test_sharded_stepped.py:143-151``);
* ``route_sharded_global``'s full contract against JAX's ``route()`` and
  the port's ``route_stepped``: rtol 1e-8, atol 1e-8
  (``test_sharded.py:371-372``);
* float32 against the port's ``route_stepped``: the strict f32 bar of
  ``test_torch_cli.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from sharded_cases import (DT, assert_state_close, conn_case, da_case,
                           global_case, jax_gage_da, port_cfg, port_route)
from test_torch_cli import f32_bar
from test_torch_sharded import forced, jax_inputs, shard_case
from troute_torch.parallel import ranks
from troute_torch.parallel.group import spawn_ranks
from troute_tpu.ops.levelpool import LevelpoolParams as JLevelpoolParams
from troute_tpu.parallel.sharded_engine import route_sharded
from troute_tpu.parallel.stepped_engine import route_sharded_strict_stepped
from troute_tpu.routing.engine import (ChannelParams, RoutingConfig,
                                       network_arrays_from_topology, route)

STEPPED = dict(rtol=2e-7, atol=1e-7)
ROUTE = dict(rtol=1e-8, atol=1e-8)
NTS = 6
NTS_STEPPED = 3   # JAX's stepped driver runs Pallas interpreted on the CPU


@pytest.fixture(scope="module")
def setup():
    conn = conn_case(gages=(3, 22))
    dac = da_case()
    strict = port_cfg(nts=NTS, assume_short_ts=False, strict_iterative=True)
    cases = {
        # the JAX drivers' defaults: no accelerator in scan (here chunks
        # of 16), the accelerator in chunks of 8 in the stepped driver
        "w2_scan": shard_case(conn, 2, NTS, strict=True),
        "w4_stepped": shard_case(conn, 4, NTS_STEPPED, strict=True,
                                 accel_lin=8),
        "w4_contract": global_case(dac, 4, strict,
                                   assignment=forced(dac.topo, 4)),
        "w2_conn": global_case(conn, 2, strict,
                               assignment=forced(conn.topo, 2)),
        "w1_conn": global_case(conn, 1, strict),
        "w2_conn_float32": global_case(conn, 2, strict, "float32",
                                       assignment=forced(conn.topo, 2)),
    }
    for c in ("w2_scan", "w4_stepped"):
        cases[c]["qts"] = 2
    out = spawn_ranks(ranks.run_cases, 4, args=(list(cases.values()),),
                      timeout=240)
    res = {k: [r["cases"][i] for r in out] for i, k in enumerate(cases)}
    return dict(res=res, procs=out, conn=conn, dac=dac, strict=strict)


def test_shard_matches_jax_strict_scan(setup):
    """2 ranks, forced cuts, gages: rank by rank against JAX's in-scan
    strict ``route_sharded`` (sweeps to the fixed point, then a commit
    sweep)."""
    conn = setup["conn"]
    part, inp, _ = jax_inputs(conn, 2, NTS)
    mesh = Mesh(np.array(jax.devices()[:2]), ("basin",))
    want = route_sharded(mesh, inp, DT, NTS, qts_subdivisions=2,
                         band_shifts=part.band_shifts, strict=True)
    outs = setup["res"]["w2_scan"]
    for r in range(2):
        for f in ("fvd", "nudge", "lo_val"):
            np.testing.assert_allclose(outs[r][f],
                                       np.asarray(getattr(want, f))[r],
                                       err_msg=f"rank {r} {f}", **STEPPED)
        assert outs[r]["strict_sweeps"] == outs[0]["strict_sweeps"]


def test_shard_matches_jax_strict_stepped(setup):
    """4 ranks, forced cuts, gages, the accelerator: rank by rank against
    JAX's host-stepped ``route_sharded_strict_stepped``; B1 ran once per
    sweep on every rank."""
    conn = setup["conn"]
    part, inp, _ = jax_inputs(conn, 4, NTS_STEPPED)
    mesh = Mesh(np.array(jax.devices()[:4]), ("basin",))
    want = route_sharded_strict_stepped(mesh, inp, DT, NTS_STEPPED,
                                        qts_subdivisions=2,
                                        band_shifts=part.band_shifts)
    outs = setup["res"]["w4_stepped"]
    for r in range(4):
        for f in ("fvd", "nudge", "lo_val"):
            np.testing.assert_allclose(outs[r][f],
                                       np.asarray(getattr(want, f))[r],
                                       err_msg=f"rank {r} {f}", **STEPPED)
        assert outs[r]["mc_calls"] == sum(outs[r]["strict_sweeps"])
        assert outs[r]["strict_sweeps"] == outs[0]["strict_sweeps"]


def test_global_contract_matches_jax_route(setup):
    """Typed reservoir DA and gages, every node on another rank than its
    neighbours: the full contract against JAX's strict ``route()`` and the
    port's strict ``route_stepped``."""
    dac = setup["dac"]
    got = setup["res"]["w4_contract"][0]
    jd = jnp.float64
    cfg = RoutingConfig(dt=DT, nts=NTS, qts_subdivisions=4,
                        assume_short_ts=False, strict_iterative=True)
    ref = route(network_arrays_from_topology(dac.topo, need_levels=False),
                ChannelParams(**{k: jnp.asarray(v, jd)
                                 for k, v in dac.chan.items()}),
                JLevelpoolParams(*[jnp.asarray(dac.params[:, i], jd)
                                   for i in range(9)]), cfg,
                jnp.asarray(dac.q0, jd), jnp.asarray(dac.depth0, jd),
                jnp.asarray(dac.elev0, jd), jnp.asarray(dac.qlat, jd),
                jax_gage_da(dac), dac.res_da)
    np.testing.assert_allclose(got["fvd"], np.asarray(ref["flowveldepth"]),
                               **ROUTE)
    np.testing.assert_allclose(got["nudge"], np.asarray(ref["nudge"]),
                               **ROUTE)
    assert_state_close(got["state"], ref["state"], **ROUTE)
    port = port_route(dac, setup["strict"])
    np.testing.assert_allclose(got["fvd"], port["flowveldepth"], **ROUTE)
    assert_state_close(got["state"], port["state"], **ROUTE)
    assert len(got["strict_sweeps"]) == NTS


@pytest.mark.parametrize("d", [1, 2])
def test_conn_matches_route_stepped(setup, d):
    got = setup["res"][f"w{d}_conn"][0]
    want = port_route(setup["conn"], setup["strict"])
    np.testing.assert_allclose(got["fvd"], want["flowveldepth"], **ROUTE)
    np.testing.assert_allclose(got["nudge"], want["nudge"], **ROUTE)
    assert got["mc_calls"] == sum(got["strict_sweeps"])


def test_float32_at_the_strict_f32_bar(setup):
    got = setup["res"]["w2_conn_float32"][0]
    want = port_route(setup["conn"], setup["strict"], "float32")
    assert got["fvd"].dtype == np.float32
    f32_bar(got["fvd"], want["flowveldepth"], strict=True)


def test_strict_ranks_launched_no_kernel_and_imported_no_jax(setup):
    for r, proc in enumerate(setup["procs"]):
        assert proc["launches"] == 0 and proc["skip_launches"] == 0, r
        assert proc["foreign"] == [], (r, proc["foreign"])

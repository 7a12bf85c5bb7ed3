"""The port stands on PyTorch alone: importing ``troute_torch`` and
routing a network with it loads no JAX, nothing of the JAX package
(``troute_tpu``) and not its ``bench.py``, and no file of the package or
``chip_smoke.py`` imports them."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import numpy as np
import torch
import troute_torch
from troute_torch.network.topology import build_topology_postorder
from troute_torch.ops.levelpool import LevelpoolParams
from troute_torch.routing import engine
from troute_torch import convert

ids = np.arange(1, 9)
down = np.array([2, 3, 4, 0, 6, 4, 8, 0])
topo = build_topology_postorder(ids, down)
n, f64 = topo.n_nodes, torch.float64
net = engine.network_arrays_from_topology(topo, device="cpu")
rng = np.random.default_rng(0)
chan = engine.ChannelParams.from_arrays(
    device="cpu", dtype=f64, dx=rng.uniform(500, 3000, n),
    bw=rng.uniform(2, 20, n), tw=rng.uniform(25, 60, n),
    twcc=rng.uniform(80, 200, n), n=np.full(n, 0.055), ncc=np.full(n, 0.11),
    cs=rng.uniform(0.3, 1.5, n), s0=rng.uniform(0.001, 0.02, n))
lp = LevelpoolParams(*[torch.ones(1, dtype=f64)] * 9)
cfg = engine.RoutingConfig(dt=300.0, nts=3, assume_short_ts=True)
q0 = torch.as_tensor(rng.uniform(0.5, 5.0, n), dtype=f64)
out = engine.route_stepped(net, chan, lp, cfg, q0, 0.1 * q0,
                           torch.zeros(1, dtype=f64),
                           torch.full((1, n), 0.5, dtype=f64))
fvd = convert.to_numpy(out)["flowveldepth"]
assert fvd.shape == (3, n, 3) and np.isfinite(fvd).all()
print("jax" in sys.modules, any(m.startswith("jax.") for m in sys.modules))
"""


def test_port_runs_without_jax():
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_ENABLE_X64", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["False", "False"], res.stdout


def test_no_file_of_the_port_imports_jax():
    pat = re.compile(r"^\s*(import\s+jax|from\s+jax[\s.])", re.M)
    files = sorted((REPO / "troute_torch").rglob("*.py"))
    assert files
    for f in files:
        assert not pat.search(f.read_text()), f


# two spawned gloo ranks route the probe's network with every node on
# another rank than its neighbours; each reports what it imported
_SHARDED = """
from troute_torch.parallel import ranks as pranks
from troute_torch.parallel.group import spawn_ranks
case = dict(kind="global", world=2, dtype="float64", topo=topo,
            chan={k: v.numpy() for k, v in chan._asdict().items()},
            res_params=None, cfg=cfg, q0=q0.numpy(), depth0=0.1 * q0.numpy(),
            elev0=np.zeros(1), qlat=np.full((1, n), 0.5),
            assignment=(np.arange(n) % 2).astype(np.int32))
outs = spawn_ranks(pranks.run_cases, 2, args=([case],), timeout=120)
assert all(o["foreign"] == [] for o in outs), outs
assert outs[0]["cases"][0]["cut_edges"] > 0
np.testing.assert_allclose(outs[0]["cases"][0]["fvd"], fvd, rtol=1e-9,
                           atol=1e-12)
"""

_PROBE_ALL = """
import importlib, pkgutil, sys
sys.modules["h5py"] = None      # hidden: any ``import h5py`` now raises
import numpy as np
import torch
import troute_torch
names = [m.name for m in pkgutil.walk_packages(troute_torch.__path__,
                                               "troute_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("cli", "__main__", "config.schema", "io.netcdf", "io.output",
             "io.restart", "io.forcing", "io.routelink", "io.timeslice",
             "io.rfc", "network.builder", "network.graph",
             "network.hyfeatures", "network.gl_constants",
             "network.rfc_crosswalk", "da_assembly", "parity",
             "diffusive.xsection", "diffusive.solver", "diffusive.domain",
             "io.coastal", "routing.hybrid", "bmi", "bmi.codec",
             "bmi.bmi_troute", "bmi.bmi_reservoirs", "bmi.bmi_daforcing",
             "parallel", "parallel.partition", "parallel.sharded_engine",
             "parallel.stepped_engine", "parallel.group", "parallel.ranks"):
    assert "troute_torch." + name in names, name
from troute_torch.io.netcdf import NetCDFFile
try:
    NetCDFFile("absent.nc")
except ImportError as e:
    assert "h5py" in str(e), e
else:
    raise AssertionError("a NetCDF read without h5py did not raise")
import chip_smoke
from troute_torch.diffusive import domain as ddom, solver as dsol
from troute_torch.synthetic import mainstem_tree
dd = ddom.build_domain(*mainstem_tree(3, 4, nts=2), device="cpu",
                       nel_uniform=16)
dst = dsol.initialize_state(dd, torch.full((3, 4), 30.0, dtype=torch.float64),
                            30.0, corrector_mode="jacobi")
dst, saves = dsol.run_diffusive(dd, dst, 600.0, 300.0,
                                corrector_mode="jacobi")
assert len(saves) == 2 and bool(torch.isfinite(dst.y).all())
from troute_torch import synthetic
from troute_torch.bmi import BmiTroute
from troute_torch.bmi.bmi_reservoirs import BmiReservoir
from troute_torch.config.schema import HybridParameters
from troute_torch.routing.hybrid import HybridDomain, run_mainstem
h = synthetic.hybrid_regional(2000, 4, 2, reaches=(3, 5))
hyb = HybridDomain.from_routelink(h["rl"], h["domain"])
mc_ids = h["rl"].ids[~np.isin(h["rl"].ids, list(hyb.mainstem_set))]
hy = run_mainstem(hyb, np.ones((2, mc_ids.size, 3), np.float32), mc_ids,
                  np.ones(mc_ids.size), 0.5, 300.0, 12, HybridParameters(),
                  "cpu")
assert hy["fvd"].shape == (2, mc_ids.size + len(hyb.mainstem_set), 3)
assert np.isfinite(hy["fvd"]).all()
bmi = BmiTroute(device="cpu")
bmi.initialize()
bmi.set_value("segment_id", np.arange(1, 5))
bmi.set_value("segment_toid", np.array([2, 3, 4, 0]))
for k, v in dict(dx=1500.0, bw=8.0, tw=24.0, twcc=72.0, n=0.05, ncc=0.1,
                 cs=0.8, s0=0.004).items():
    bmi.set_value(k, np.full(4, v))
bmi.set_value("land_surface_water_source__volume_flow_rate", np.ones(4))
bmi.update()
assert (bmi.get_value("channel_exit_water_x-section__volume_flow_rate")
        > 0).all()
res = BmiReservoir(device="cpu")
res.initialize()
for k, v in dict(LkArea=2.0, LkMxE=12.0, OrificeA=1.2, OrificeC=0.1,
                 OrificeE=8.0, WeirC=0.4, WeirE=11.0, WeirL=12.0,
                 lake_surface__elevation=10.5).items():
    res.set_value(k, [v])
res.set_value("lake_water~incoming__volume_flow_rate", [5.0])
res.update()
assert res.get_value("lake_water~outgoing__volume_flow_rate")[0] > 0
""" + _PROBE.split("import troute_torch", 1)[1].replace(
    'print("jax" in sys.modules, any(m.startswith("jax.") for m in sys.modules))',
    'levels = engine.route(engine.network_arrays_from_topology(\n'
    '    topo, device="cpu", need_levels=True), chan, lp,\n'
    '    cfg._replace(assume_short_ts=False), q0, 0.1 * q0,\n'
    '    torch.zeros(1, dtype=f64), torch.full((1, n), 0.5, dtype=f64))\n'
    'assert levels["mc_calls"] == 3 * topo.n_levels\n'
    + _SHARDED + 'print("FOREIGN", chip_smoke.foreign_modules())')


def test_port_imports_nothing_of_the_jax_package():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    process from which ``h5py`` is hidden, and which then routes a tiny
    network on the CPU (short steps and the level scan), a tiny diffusive
    domain, a tiny hybrid mainstem (``run_mainstem``) and one update of
    the routing and reservoir BMIs: every module imports without ``h5py``
    (a NetCDF read then raises an ``ImportError`` that names it), and no
    module of JAX, of ``troute_tpu`` or ``bench`` is loaded, in the
    process or in its ranks."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_ENABLE_X64", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", _PROBE_ALL], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-2:] == ["FOREIGN", "[]"], res.stdout


@pytest.mark.parametrize("name", ["troute_tpu", "bench", "jax"])
def test_no_source_of_the_port_imports_the_jax_side(name):
    pat = re.compile(rf"^\s*(import\s+{name}\b|from\s+{name}[\s.])", re.M)
    files = sorted((REPO / "troute_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert {"solver.py", "domain.py", "xsection.py"} <= {
        f.name for f in files if f.parent.name == "diffusive"}
    assert {"bmi_troute.py", "bmi_reservoirs.py", "bmi_daforcing.py",
            "codec.py"} <= {f.name for f in files if f.parent.name == "bmi"}
    assert {"hybrid.py", "coastal.py"} <= {f.name for f in files}
    assert {"partition.py", "sharded_engine.py", "stepped_engine.py",
            "group.py", "ranks.py"} <= {f.name for f in files
                                        if f.parent.name == "parallel"}
    for f in files:
        assert not pat.search(f.read_text()), f

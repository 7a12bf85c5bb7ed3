"""What a process loads, checked in a fresh interpreter: the plain
reference and the counts load nothing of the program, and the harness
and its drivers load neither JAX nor the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def loaded_after(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def tops(mods):
    return {m.split(".", 1)[0] for m in mods}


def test_reference_loads_nothing_of_the_program():
    mods = loaded_after(
        "import hydrobench.reference.mc_levelpool, hydrobench.roofline,"
        " hydrobench.gen.networks, hydrobench.gen.forcing")
    assert not tops(mods) & {"troute_torch", "jax", "jaxlib", "flax",
                             "troute_tpu", "bench"}


def test_harness_and_drivers_load_no_jax():
    mods = loaded_after(
        "import hydrobench.harness, hydrobench.drivers.stepped,"
        " hydrobench.drivers.bmi, troute_torch.routing.engine,"
        " troute_torch.bmi")
    assert not tops(mods) & {"jax", "jaxlib", "flax", "troute_tpu", "bench"}

"""Shared set-up of the benchmark's own tests (``python -m pytest
hydrobench/tests``): the checkout's root on the path, the ``cuda`` marker
for tests that need a card, and a tiny copy of the benchmark's cells for
CPU runs of the whole harness."""

import copy
import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU; skipped where none is visible")


def tiny_manifest(tmp_path: Path) -> tuple:
    """(manifest, root, traffic dir): BENCHMARK.json's cells with their
    configurations cut to a few thousand segments and their traffic to
    one spin-up hour, written under ``tmp_path``."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest = copy.deepcopy(manifest)
    for c in manifest["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        if cfg["driver"] == "stepped":
            cfg["network"].update(segments=1500, basins=15,
                                  lake_per_segments=100)
        else:
            cfg["network"].update(segments=1200, basins=12,
                                  lake_per_segments=100)
        cfg["trace_units"] = 1
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    traffic = tmp_path / "traffic"
    traffic.mkdir()
    for f in (ROOT / "hydrobench" / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t["spinup_units"] = 1
        (traffic / f.name).write_text(json.dumps(t))
    return manifest, ROOT, traffic


@pytest.fixture
def tiny(tmp_path):
    return tiny_manifest(tmp_path)

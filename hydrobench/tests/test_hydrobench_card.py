"""On the card (marker ``cuda``; ``python -m pytest -m cuda
hydrobench/tests``): one short run of each cell through the command, whose
last line is the result in the contract's form."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_one_run_prints_the_result(workload, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    proc = subprocess.run(
        [sys.executable, *M["command"][1:], "--workload", workload,
         "--seed", str(2 ** 33 + 5), "--seconds", "2", "--trace",
         str(trace)], cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert "H100" in r["device"]["kind"] and r["device"]["count"] == 1
    assert r["device"]["memory_peak_bytes"] > 0
    assert list(r)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in M[kind]
             if workload in m.get("workloads", [workload])}
    assert set(r["metrics"]) <= names and r["metrics"]
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    else:
        assert set(r["metrics"]) == names

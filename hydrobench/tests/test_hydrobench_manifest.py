"""BENCHMARK.json against the form the benchmark's contract sets, and
each name in it against the file the harness finds by it."""

import ast
import importlib.util
import json
import re
from pathlib import Path

import pytest

from hydrobench import harness

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                    r"|(_dim|_rank)$")


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(M)) <= 64 * 1024
    assert 1 <= len(M["command"]) <= 32 and all(map(line, M["command"]))
    for p in M["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    for word in M["command"]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in M["paths"])
    r = M["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    # a full check of 24 cells fits
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    names = [c["name"] for c in M["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    files = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in M["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
        assert cfg["source"] == c["source"]
        assert (ROOT / "hydrobench" / "drivers"
                / f"{cfg['driver']}.py").exists()
        assert (ROOT / "hydrobench" / "reference"
                / f"{cfg['reference']}.py").exists()
        assert any(w["config"] == c["name"] for w in M["workloads"])


def test_workloads():
    names = [w["name"] for w in M["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(names)
    configs = {c["name"] for c in M["configs"]}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert line(w["why"])
        assert (ROOT / "hydrobench" / "traffic"
                / f"{w['traffic']}.json").exists()
    assert sum(w["chips"] == 4 for w in M["workloads"]) \
        <= max(1, len(names) // 4)


def test_metrics():
    e2e = {m["name"] for m in M["end_to_end"]}
    every = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(every)) == len(every)
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in M["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert line(m["layer"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_every_cell_reports_what_it_must():
    for w in M["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(M, "end_to_end",
                                                     w["name"])}
        layer = harness.metrics_of(M, "per_layer", w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e
        cfg = harness.cell(M, w["name"], ROOT)[1]
        assert e2e == {"setup_s", *cfg["metrics"].values()}


@pytest.mark.parametrize("m", M["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_its_reader(m):
    path = ROOT / "hydrobench" / "metrics" / f"{m['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.SOURCE == m["source"] and mod.MOVES == m["moves"]
    assert callable(mod.read)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "troute_tpu", "bench"}
    for path in (ROOT / "hydrobench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not banned & set(tops), (path, tops)

"""BENCHMARK.json and the files its cells resolve to; the import rules."""

import ast
import json
import re

import pytest

from portbench.harness import cells

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(workload):
    c = cells.load(workload)
    w = next(w for w in BENCH["workloads"] if w["name"] == workload)
    assert workload == f"{w['config']}.{w['traffic']}"
    for name in ("argv", "expected", "read_job", "compare", "summary"):
        assert callable(getattr(c.tool, name)), name
    assert c.tool.LIMITS
    assert {m["name"] for m in c.end_to_end} >= {"job_s", "setup_s"}
    assert c.per_layer and all(callable(m.read) for m in c.per_layer)
    cfg = next(x for x in BENCH["configs"] if x["name"] == w["config"])
    assert (ROOT / cfg["file"]).is_file()


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert all((ROOT / p).is_dir() for p in BENCH["paths"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench").rglob("*.py")), ids=lambda p: p.name)
def test_no_jax_and_a_plain_reference(path):
    banned = {"jax", "jaxlib", "flax", "metafast_tpu"}
    if "reference" in path.parts:
        banned.add("metafast_tpu_torch")
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & banned, f"{path}: imports {tops & banned}"

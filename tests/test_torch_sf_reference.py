"""Pipeline 5 (stats-features) of the port against the benchmark's plain
reference (portbench/reference/stats_features.py), on the CPU.

The port runs whole jobs through ``cli.main`` on a tiny two-site
community of 2 x 4 samples generated from a seed
(portbench/tests/tiny_groups.json); the benchmark's tool module reads the
outputs back and compares them with the reference, number by number.
Two broken jobs must come out not equal.  The Mann-Whitney rows and the
reference's imports are checked on their own.
"""

import ast
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from metafast_tpu_torch import cli
from portbench.gen.community import Traffic, generate
from portbench.reference import stats_features as reference
from portbench.tools import stats_features as tool

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "sf_hmp.json")
                    .read_text())
TINY = ROOT / "portbench" / "tests" / "tiny_groups.json"
SEED = 2**33 + 7

# case -> (b, pmw, fault)
CASES = {
    "b1-pmw0.05": (1, 0.05, None),
    "b1-pmw0": (1, 0.0, None),           # every chi2 survivor kept
    "b0-pmw0.05": (0, 0.05, None),
    "b0-pmw0": (0, 0.0, None),
    "dropped-selected-key": (1, 0.05, "dropped"),
    "swapped-groups": (1, 0.05, "swapped"),
}


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    return generate(Traffic.load(TINY), SEED,
                    tmp_path_factory.mktemp("sf_reads"))


_WANT: dict = {}


def _expected(samples, params):
    key = (params["b"], params["pmw"])
    if key not in _WANT:
        _WANT[key] = tool.expected(samples, params, "cpu", {})
    return _WANT[key]


def _drop_one_record(path: Path) -> None:
    rec = np.fromfile(path, dtype=[("key", ">i8"), ("cnt", ">i2")])
    np.delete(rec, len(rec) // 2).tofile(path)


@pytest.mark.parametrize("case", list(CASES))
def test_port_against_reference(case, samples, tmp_path):
    b, pmw, fault = CASES[case]
    params = dict(CONFIG["params"], b=b, pmw=pmw)
    run = dict(params)
    if fault == "swapped":
        run["groups"] = {"pos": params["groups"]["neg"],
                         "neg": params["groups"]["pos"]}
    files = [f for s in samples for f in s.files]
    wd = tmp_path / "wd"
    assert cli.main(tool.argv(dict(CONFIG, params=run), files, wd,
                              "cpu")) == 0
    if fault == "dropped":
        _drop_one_record(wd / "stats-kmers" / "kmers"
                         / "filtered_groupA.kmers.bin")
    want = _expected(samples, params)
    assert len(want.group_a[0]) and len(want.group_b[0]) and want.components
    got = tool.read_job(wd, sorted(s.name for s in samples))
    numbers = tool.compare(got, want)
    assert set(numbers) == set(tool.LIMITS)
    if fault is None:
        assert all(v == 0 for v in numbers.values()), numbers
    elif fault == "dropped":
        assert numbers["selected_off"] == 1, numbers
    else:
        assert numbers["selected_off"] > 0, numbers
        assert numbers["components_off"] > 0, numbers
        assert numbers["features_off"] > 0, numbers


def _phi(x):
    return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


# (a, b, U, p): 4 against 4, p = 2 Phi((U - 8) / sqrt(12))
MW_ROWS = {
    "U0-b-tied-zeros": ([1, 2, 3, 4], [0, 0, 0, 0], 0, 0.0209),
    "U1": ([0.5, 2, 3, 4], [0, 0, 0, 1], 1, 0.0433),
    "U2": ([1, 1.5, 3, 4], [0, 0, 0, 2], 2, 0.0833),
}


@pytest.mark.parametrize("row", list(MW_ROWS))
def test_mann_whitney_rows(row):
    a, b, u, p = MW_ROWS[row]
    got = reference.mann_whitney_p(
        torch.tensor([a], dtype=torch.float64),
        torch.tensor([b], dtype=torch.float64)).item()
    assert got == pytest.approx(2 * _phi((u - 8) / math.sqrt(12)),
                                rel=1e-12)
    assert got == pytest.approx(p, abs=5e-5)
    assert (got < 0.05) == (u < 2)
    # the group order does not change a two-sided p
    assert reference.mann_whitney_p(
        torch.tensor([b], dtype=torch.float64),
        torch.tensor([a], dtype=torch.float64)).item() == got


def test_reference_imports_no_program_code():
    """The reference and the matrix reference it reuses import nothing of
    the program, the JAX package or JAX."""
    for name in ("stats_features.py", "matrix.py"):
        tree = ast.parse((ROOT / "portbench" / "reference" / name)
                         .read_text())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                mods.add("." * node.level + (node.module or ""))
        assert mods, name
        assert not {m for m in mods if m.split(".")[0] in
                    ("jax", "jaxlib", "metafast_tpu", "metafast_tpu_torch")}
        assert {m for m in mods if m.startswith(".")} <= {".", ".matrix"}

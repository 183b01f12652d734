"""Fixtures of the benchmark's own tests (portbench/tests)."""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench.gen.community import Traffic  # noqa: E402
from portbench.harness import cells  # noqa: E402

TINY = Path(__file__).with_name("tiny.json")


@pytest.fixture
def tiny_cell():
    """A test-size cell (not in BENCHMARK.json): mb_defaults on tiny.json."""
    cfg = json.loads((ROOT / "portbench" / "configs" /
                      "mb_defaults.json").read_text())
    return cells.Cell("tiny", 1, cfg, Traffic.load(TINY), [], [])


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"

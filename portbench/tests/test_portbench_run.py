"""The entry point: no card, no result; no program, no result."""

import shutil
import subprocess
import sys

from .conftest import ROOT


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    sys.path.insert(0, str(ROOT / "portbench"))
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "mb_defaults.sites10", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert "{" not in out.out
    assert "needs 1 CUDA device" in out.err


def test_no_program_no_result(tmp_path):
    """A checkout of BENCHMARK.json and portbench/ alone, with a card
    faked, stops where it would import the package under test."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, runpy, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['portbench/run.py', '--workload', "
            "'mb_defaults.sites10', '--seed', '1', '--seconds', '1', "
            "'--trace', '0']\n"
            "runpy.run_path('portbench/run.py', run_name='__main__')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "metafast_tpu_torch" in p.stderr

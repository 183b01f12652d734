"""The port's ``--shards n`` launcher (parallel/distributed.launch) on the CPU.

``python -m metafast_tpu_torch.cli --shards 2 --device cpu`` runs two gloo
ranks as subprocesses; its work dir must equal, byte for byte, the JAX
CLI's ``--shards 2`` (in-process, on the 8-device CPU mesh of
tests/conftest.py) and the port's unsharded run.  Also: the JAX message
above the GPU count, a failing rank, and ranks that never import jax.
"""

import os
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

from metafast_tpu import api as jax_api
from metafast_tpu import cli as jax_cli
from metafast_tpu_torch import cli
from metafast_tpu_torch.parallel import distributed as D
from torch_helpers import assert_same_tree, write_samples

REPO = Path(__file__).resolve().parents[1]


# a rank that refuses jax and the JAX package, and checks at exit that
# neither was imported
NO_JAX_RANK = [sys.executable, "-c", """
import sys
sys.modules["jax"] = None
sys.modules["metafast_tpu"] = None
from metafast_tpu_torch.cli import main
rc = main()
assert not [m for m, v in sys.modules.items() if v is not None and
            m.split(".")[0] in ("jax", "metafast_tpu")]
sys.exit(rc)
"""]

# a rank 1 that fails inside the counting route, after every rank wrote
# its pid
FAILING_RANK = [sys.executable, "-c", """
import os, sys
from metafast_tpu_torch import api
rank = os.environ["METAFAST_RANK"]
with open(os.path.join(os.environ["PID_DIR"], rank), "w") as fh:
    fh.write(str(os.getpid()))
if rank == "1":
    def fail(*args, **kwargs):
        raise RuntimeError("rank 1 fails")
    api.count_reads_files_sharded = fail
from metafast_tpu_torch.cli import main
sys.exit(main())
"""]


@pytest.fixture(scope="module")
def shard_samples(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_samples")
    return write_samples(root, 3, 20_000, 8_000, 12, seed=13)


@pytest.fixture
def isolated_tmp(tmp_path, monkeypatch):
    """TMPDIR of the launcher and its ranks, to see what they leave."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    return tmp


def test_cli_shards_matches_jax_and_unsharded(shard_samples, tmp_path,
                                              isolated_tmp, monkeypatch):
    monkeypatch.setattr(D, "RANK_CMD", NO_JAX_RANK)
    args = ["-k", "31", "-i", *shard_samples, "-b1", "100", "-b2", "3000"]
    sharded = tmp_path / "port_shards"
    assert cli.main([*args, "-w", str(sharded), "--shards", "2",
                     "--device", "cpu"]) == 0
    assert list(isolated_tmp.iterdir()) == []   # rank 1 left nothing
    try:
        assert jax_cli.main([*args, "-w", str(tmp_path / "jax_shards"),
                             "--shards", "2"]) == 0
    finally:
        jax_api.set_default_mesh(None)
    assert cli.main([*args, "-w", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    tree = assert_same_tree(tmp_path / "jax_shards", sharded)
    assert_same_tree(tmp_path / "port", sharded)
    assert "component-cutter/components.bin" in tree
    log = (sharded / "log").read_text()
    assert "running on cpu" in log and "[matrix-builder] done" in log


def test_sharded_runs_resume_like_unsharded(shard_samples, tmp_path,
                                            isolated_tmp, monkeypatch):
    """--shards with --finish, then --continue, then --start: every rank
    follows rank 0's skip decisions (ranks above 0 read the skipped
    steps' outputs from rank 0's work dir), and the work dir ends equal
    to one unsharded run's."""
    monkeypatch.setattr(D, "RANK_CMD", NO_JAX_RANK)
    args = ["-k", "31", "-i", *shard_samples, "-b1", "100", "-b2", "3000",
            "--device", "cpu"]
    wd = tmp_path / "sharded"
    sharded = [*args, "-w", str(wd), "--shards", "2"]
    assert cli.main([*sharded, "--finish", "seq-builder-many"]) == 0
    assert not (wd / "component-cutter").exists()
    assert cli.main([*sharded, "-c"]) == 0
    log = (wd / "log").read_text()
    assert "[seq-builder-many] up to date, skipped" in log
    assert cli.main([*sharded, "--start", "component-cutter"]) == 0
    log = (wd / "log").read_text()
    assert "[seq-builder-many] skipped (before --start)" in log
    assert list(isolated_tmp.iterdir()) == []
    assert cli.main([*args, "-w", str(tmp_path / "port")]) == 0
    assert_same_tree(tmp_path / "port", wd)


def test_shards_above_the_gpu_count_exit_1(shard_samples, tmp_path,
                                           monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    wd = tmp_path / "wd"
    assert cli.main(["-k", "31", "-i", shard_samples[0], "-w", str(wd),
                     "--shards", "3", "--device", "cuda"]) == 1
    assert ("ERROR: --shards 3 exceeds available devices (1)"
            in capsys.readouterr().out)
    assert not wd.exists()


def test_a_failing_rank_fails_the_run(shard_samples, tmp_path, isolated_tmp,
                                      monkeypatch):
    monkeypatch.setattr(D, "RANK_CMD", FAILING_RANK)
    pids = tmp_path / "pids"
    pids.mkdir()
    monkeypatch.setenv("PID_DIR", str(pids))
    t0 = time.monotonic()
    rc = cli.main(["-k", "31", "-i", *shard_samples, "-w",
                   str(tmp_path / "wd"), "--shards", "2", "--device", "cpu"])
    assert rc != 0
    assert time.monotonic() - t0 < 120
    assert sorted(p.name for p in pids.iterdir()) == ["0", "1"]
    for p in pids.iterdir():
        with pytest.raises(ProcessLookupError):
            os.kill(int(p.read_text()), 0)
    assert list(isolated_tmp.iterdir()) == []


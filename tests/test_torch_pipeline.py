"""The port's whole matrix pipeline against the JAX package, on the CPU.

Three synthetic samples share a backbone; both packages run
matrix_pipeline on the same FASTA files and every field of the result
must be equal.  Two subprocesses show that the port needs neither JAX nor
the JAX package and that chip_smoke.py has no CPU fallback; an AST scan
shows that no module of the port imports either.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from metafast_tpu.pipeline import matrix_pipeline as jax_pipeline
from metafast_tpu_torch.api import write_binq
from metafast_tpu_torch.pipeline import matrix_pipeline
from torch_helpers import write_samples

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def samples(tmp_path_factory):
    return write_samples(tmp_path_factory.mktemp("torch_pipeline"), 3,
                         30_000, 12_000, 12, seed=11)


def test_matrix_pipeline_matches_jax(samples):
    kw = dict(k=31, b=1, l=100, b1=100, b2=3000)
    want = jax_pipeline(samples, **kw)
    got = matrix_pipeline(samples, device="cpu", **kw)
    assert len(want.components) >= 3
    assert got.names == want.names
    assert np.array_equal(got.matrix, want.matrix)
    assert got.matrix.dtype == want.matrix.dtype
    assert np.array_equal(got.vectors, want.vectors)
    assert got.vectors.dtype == want.vectors.dtype
    assert np.array_equal(got.breadth, want.breadth)
    assert got.contigs_per_sample == want.contigs_per_sample
    assert len(got.components) == len(want.components)
    for g, w in zip(got.components, want.components):
        assert np.array_equal(g.kmers, w.kmers)
        assert (g.weight, g.used_freq_threshold) == (
            w.weight, w.used_freq_threshold)
    for (gk, gc), (wk, wc) in zip(got.sample_tables, want.sample_tables):
        assert np.array_equal(gk, wk) and np.array_equal(gc, wc)
    off = want.matrix[~np.eye(3, dtype=bool)]
    assert (off > 0).all() and (off < 1).all()


def test_cli_writes_matrix(samples, tmp_path):
    from metafast_tpu.io import textfmt
    from metafast_tpu_torch import cli

    assert cli.main(["-k", "31", "-i", *samples, "-w", str(tmp_path),
                     "--device", "cpu"]) == 0
    (out,) = (tmp_path / "matrices").glob("dist_matrix_*_original_order.txt")
    mat, names = textfmt.read_dist_matrix(str(out))
    assert names == ["sample_0", "sample_1", "sample_2"]
    assert mat.shape == (3, 3) and np.allclose(np.diag(mat), 0)


_NO_JAX = """
import sys
sys.modules["jax"] = None          # any import of jax now fails
sys.modules["metafast_tpu"] = None  # and any of the JAX package
import numpy as np
import torch
from metafast_tpu_torch import api
from metafast_tpu_torch.core import extract
from metafast_tpu_torch.ops import psort
from metafast_tpu_torch.pipeline import matrix_pipeline
binq, files = sys.argv[1], sys.argv[2:]
res = matrix_pipeline(files, k=21, b=1, l=60, b1=20, b2=5000, device="cpu")
assert res.matrix.shape == (len(files), len(files))
assert len(res.components) >= 1
keys, counts, stats = api.count_reads_files([binq], 21, "cpu")
assert stats["reads"] > 0 and len(keys) > 0
sorted_keys, = psort.sort_arrays_blocked((keys[:1024].flip(0),), log_block=10)
assert torch.equal(sorted_keys, keys[:1024])
assert extract.unpack_2bit(torch.tensor([[228]], dtype=torch.uint8),
                           4).tolist() == [[0, 1, 2, 3]]
# the CLI's default tool and one tool of every other ported tool module
from pathlib import Path
from metafast_tpu_torch import cli
wd = Path(files[0]).parent / "wd"
assert cli.main(["-t", "matrix-builder", "-k", "21", "-i", *files, "-l", "60",
                 "-b1", "20", "-b2", "5000", "-w", str(wd),
                 "--device", "cpu"]) == 0
assert list((wd / "matrices").glob("dist_matrix_*_original_order.txt"))
kb = sorted(map(str, (wd / "kmer-counter-many" / "kmers").glob("*.kmers.bin")))
comps = str(wd / "component-cutter" / "components.bin")
for tool in (["unique-kmers", "-i", kb[0], "--filter-kmers", kb[1]],
             ["kmers-samples-counter", "-i", *kb],
             ["view", "-kf", kb[0], "-o", str(wd / "view.txt")],
             ["comp2graph", "-cf", comps]):
    assert cli.main(["-t", *tool, "-k", "21", "-w", str(wd / tool[0]),
                     "--device", "cpu"]) == 0, tool[0]
assert not any(m == "jax" or m.startswith("jax.") for m, v in
               sys.modules.items() if v is not None)
assert not any(m == "metafast_tpu" or m.startswith("metafast_tpu.")
               for m, v in sys.modules.items() if v is not None)
print("ok", len(res.components))
"""


def test_port_runs_without_jax(tmp_path):
    files = write_samples(tmp_path, 2, 3000, 1000, 8, read_len=100, seed=5)
    rng = np.random.default_rng(5)
    binq = write_binq(tmp_path / "reads.binq",
                      rng.integers(0, 4, 100 * 60, dtype=np.uint8),
                      np.full(100, 60, np.int32))
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, binq, *files],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax_package():
    """chip_smoke.py imports the port only: neither jax nor metafast_tpu,
    at module level or inside its phases."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    modules = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
               for a in n.names]
    modules += [n.module for n in ast.walk(tree)
                if isinstance(n, ast.ImportFrom)]
    assert "metafast_tpu_torch.api" in modules
    assert not [m for m in modules
                if m.split(".")[0] in ("jax", "metafast_tpu")]


def _imported_top_levels(path: Path) -> set[str]:
    """Top-level package of every import and absolute from-import."""
    tree = ast.parse(path.read_text())
    tops = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    tops |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0}
    return tops


def test_port_modules_import_no_jax_package():
    """No module of the port imports jax or metafast_tpu, at module level
    or inside a function: it keeps its own copies of the host modules."""
    files = sorted((REPO / "metafast_tpu_torch").rglob("*.py"))
    assert len(files) > 40
    bad = {str(f.relative_to(REPO)): tops & {"jax", "metafast_tpu"}
           for f in files if (tops := _imported_top_levels(f))
           & {"jax", "metafast_tpu"}}
    assert not bad


def test_native_build_stays_in_the_port(tmp_path, monkeypatch):
    """The port's C++ library builds into build/native/ under the
    checkout, keyed by source and flags, never into metafast_tpu/native/;
    a failing compiler raises."""
    from metafast_tpu_torch.native import build

    out = build.library_path()
    assert out.parent == REPO / "build" / "native" == build.BUILD_DIR
    assert out.name.startswith("fastparse-") and out.suffix == ".so"
    lib = build.load_library()
    assert Path(lib._name) == out and out.is_file()
    assert build._SRC.parent == REPO / "metafast_tpu_torch" / "native"
    # a build elsewhere writes only there, and a failing g++ raises
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "native")
    assert build._build().parent == tmp_path / "native"
    monkeypatch.setattr(build, "CXX_FLAGS",
                        [*build.CXX_FLAGS, "--no-such-flag"])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        build._build()
    assert len(list((tmp_path / "native").glob("*.so"))) == 1


def test_chip_smoke_fails_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

"""The port's tool layer and launcher against the JAX package's, on the CPU.

Both CLIs run in-process on the same inputs (JAX on its CPU backend, the
port with ``--device cpu``) and every file they write must be equal byte
for byte.  Exceptions: the heatmap PNG/SVG (only their existence is
checked), the logs, and the run timestamps in file names and in the
paths that manifests record; paths inside files are compared relative
to each run's working directory.
"""

import logging
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from metafast_tpu import api as jax_api
from metafast_tpu import cli as jax_cli
from metafast_tpu.io import binfmt
from metafast_tpu.io.reads import iter_reads
from metafast_tpu.pipeline import matrix as jax_matrix
from metafast_tpu_torch import api, cli
from metafast_tpu_torch.graph.components import Component
from metafast_tpu_torch.pipeline import matrix
from torch_helpers import assert_same_tree, write_samples
from torch_helpers import workdir_tree as _tree

K = 31
SIZES = ["-b1", "100", "-b2", "3000"]
# the tools driven here, over the files of a matrix-builder run
CHAIN_TOOLS = {
    "kmer-counter", "kmer-counter-many", "seq-builder", "seq-builder-many",
    "component-cutter", "features-calculator", "dist-matrix-calculator",
    "heatmap-maker", "matrix-builder",
    "unique-kmers", "unique-kmers-multi", "kmers-filter",
    "kmer-counter-posneg",
    "kmers-samples-counter", "kmers-grouped-counter", "kmers-per-sample",
    "kmers-multiple-filters",
    "view", "double-view", "bin2fasta", "seq2comp", "comp2seq",
    "comp2graph",
}
# the group-comparison tools, driven over sample groups in
# test_torch_group_tools.py and test_torch_group_pipelines.py
GROUP_TOOLS = {
    "stats-kmers", "stats-kmers-3", "bitset-stats-kmers-3",
    "specific-kmers", "specific-kmers-3", "top-stats-kmers",
    "subset-specific", "unique-features", "stats-features",
    "component-extractor", "component-paths", "comparison-script",
    "antibody-sequences-finder", "supergraph-sequence-builder",
    "kmers-color", "component-colored",
}
PORTED = CHAIN_TOOLS | GROUP_TOOLS


def _run(main, args, wd, *extra):
    return main([*args, "-w", str(wd), *extra])


def run_both(args, root: Path, name: str):
    """Both CLIs on ``args``: (JAX workdir, port workdir), each exit 0."""
    jwd, pwd = root / f"{name}_jax", root / f"{name}_port"
    assert _run(jax_cli.main, args, jwd) == 0
    assert _run(cli.main, args, pwd, "--device", "cpu") == 0
    return jwd, pwd


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """matrix-builder by both CLIs on three samples (>= 3 components)."""
    root = tmp_path_factory.mktemp("torch_tools")
    files = write_samples(root, 3, 30_000, 12_000, 12, seed=11)
    args = ["-k", str(K), "-i", *files, *SIZES]
    jwd, pwd = run_both(args, root, "mb")
    return dict(root=root, files=files, args=args, jax=jwd, port=pwd)


def test_matrix_builder_matches_jax(built):
    tree = assert_same_tree(built["jax"], built["port"])
    expected = ["kmer-counter-many/kmers/sample_0.kmers.bin",
                "kmer-counter-many/stats/sample_2.stat.txt",
                "seq-builder-many/seq-builder_3/distribution",
                "seq-builder-many/sequences/sample_1.seq.fasta",
                "component-cutter/components.bin",
                "component-cutter/components-stat-100-3000.txt",
                "features-calculator/vectors/sample_2.vec",
                "features-calculator/vectors/sample_0.breadth",
                "matrices/dist_matrix_<ts>_original_order.txt",
                "matrices/dist_matrix_<ts>.txt",
                "matrices/dist_matrix_<ts>_heatmap.png",
                "matrices/dist_matrix_<ts>_heatmap.svg",
                "output_description.txt"]
    for rel in expected:
        assert rel in tree, rel
    comps = binfmt.read_components_bin(
        str(built["port"] / "component-cutter" / "components.bin"))
    assert len(comps) >= 3


def _tool_args(name: str, b: dict, out: Path) -> list[str]:
    """Arguments of one tool over the files the JAX matrix-builder wrote;
    outputs that would land beside the inputs go under ``out``."""
    jwd = b["jax"]
    kb = [str(jwd / "kmer-counter-many" / "kmers" / f"sample_{i}.kmers.bin")
          for i in range(3)]
    seqs = [str(jwd / "seq-builder-many" / "sequences" /
                f"sample_{i}.seq.fasta") for i in range(3)]
    comps = str(jwd / "component-cutter" / "components.bin")
    vecs = [str(jwd / "features-calculator" / "vectors" / f"sample_{i}.vec")
            for i in range(3)]
    (mat,) = (jwd / "matrices").glob("*_original_order.txt")
    reads = b["files"]
    k = ["-k", str(K)]
    return {
        "kmer-counter": [*k, "-i", reads[0], "-b", "2"],
        "kmer-counter-many": [*k, "-i", *reads[:2]],
        "seq-builder": [*k, "-i", *kb[:2], "-l", "100",
                        "--bottom-cut-percent", "5"],
        "seq-builder-many": [*k, "-i", *kb, "-l", "80"],
        "component-cutter": [*k, "-i", *seqs, "-l", "120", *SIZES],
        "features-calculator": [*k, "-cm", comps, "-ka", *kb[:2],
                                "-i", reads[2], "--threshold", "2",
                                "--selected-kmers", kb[0]],
        "dist-matrix-calculator": ["-i", *vecs, "--without-header"],
        "heatmap-maker": ["-i", str(mat),
                          "--newMatrix-file", str(out / "renumbered.txt"),
                          "--heatmap-file", str(out / "heat.png"),
                          "--output-format", "%.6f"],
        "unique-kmers": [*k, "-i", *kb[:2], "--filter-kmers", kb[2]],
        "unique-kmers-multi": [*k, "-i", *kb, "--filter-kmers", kb[2],
                               "--min-samples", "1", "--max-samples", "3"],
        "kmers-filter": [*k, "-i", *kb[:2], "--filter-kmers", *kb[1:],
                         "--max-thresh", "2"],
        "kmer-counter-posneg": [*k, "-pos", reads[0], "-neg", *reads[1:]],
        "kmers-samples-counter": [*k, "-i", *kb, "-b", "2"],
        "kmers-grouped-counter": [*k, "--kmers-file", *kb[:2],
                                  "--cd-kmers", kb[0], "--uc-kmers", kb[1],
                                  "--nonibd-kmers", *kb[1:]],
        "kmers-per-sample": [*k, "-i", *kb, "-perc", "60"],
        "kmers-multiple-filters": [*k, "-i", *kb[:2],
                                   "--cd-filter-kmers", kb[0],
                                   "--uc-filter-kmers", kb[1],
                                   "--nonibd-filter-kmers", *kb[1:]],
        "view": [*k, "-kf", kb[0], "-cf", comps, "-o", str(out / "v.txt")],
        "double-view": [*k, "-mgx", kb[0], "-mtx", kb[1],
                        "-o", str(out / "dv.txt")],
        "bin2fasta": [*k, "-kf", kb[1], "-cf", comps, "--split",
                      "-o", str(out / "fa" / "part")],
        "seq2comp": [*k, "-i", *seqs[:2]],
        "comp2seq": [*k, "-cf", comps],
        "comp2graph": [*k, "-cf", comps, "-i", *kb[:2]],
    }[name]


@pytest.mark.parametrize("name", sorted(CHAIN_TOOLS - {"matrix-builder"}))
def test_tool_matches_jax(name, built, tmp_path):
    outs = {}
    for side, main, extra in (("jax", jax_cli.main, []),
                              ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{side}_out"
        args = ["-t", name, *_tool_args(name, built, out)]
        assert _run(main, args, tmp_path / side, *extra) == 0
        outs[side] = out
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    if outs["jax"].exists():
        assert_same_tree(outs["jax"], outs["port"])


# ---------------------------------------------------------------------------
# launcher behaviour
# ---------------------------------------------------------------------------

def test_tools_lists_the_ported_tools(capsys):
    def names(main):
        assert main(["--tools"]) == 0
        lines = capsys.readouterr().out.splitlines()
        return {ln.split()[0] for ln in lines[1:] if ln.strip()}

    got = names(cli.main)
    assert got == PORTED
    assert got == names(jax_cli.main) and len(got) == 39


def test_tool_help_matches_jax(capsys):
    """The same parameter lines; a lazy default prints as the repr of a
    function in both, whose name and address differ."""
    def params(main):
        assert main(["-t", "kmer-counter", "-h"]) == 0
        text = capsys.readouterr().out
        assert text.count("<function ") == 2
        return re.sub(r"<function \S+ at 0x[0-9a-f]+>", "<function>",
                      text.split("\nLaunch options:")[0])

    assert params(cli.main) == params(jax_cli.main)


def test_unknown_option_exits_1(built, tmp_path):
    args = ["-k", str(K), "-i", built["files"][0], "--no-such-option", "3"]
    assert _run(jax_cli.main, args, tmp_path / "j") == 1
    assert _run(cli.main, args, tmp_path / "p", "--device", "cpu") == 1


def _events(caplog) -> list[str]:
    """Step events of one run, durations and timestamps dropped."""
    keep = re.compile(r"^(\[[\w-]+\] (started|up to date, skipped|"
                      r"skipped \(before --start\))|stopping after .*)$")
    return [r.getMessage() for r in caplog.records
            if keep.match(r.getMessage())]


def _rerun(wds, args, caplog, extra):
    """``args`` + ``extra`` by both CLIs on their workdirs ``wds``:
    side -> (exit code, step events)."""
    runs = {}
    for side, main, dev in (("jax", jax_cli.main, []),
                            ("port", cli.main, ["--device", "cpu"])):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            rc = _run(main, args, wds[side], *dev, *extra)
        runs[side] = (rc, _events(caplog))
    return runs


def test_rerun_without_flags_refuses(built, caplog):
    runs = _rerun(built, built["args"], caplog, [])
    assert runs["jax"][0] == runs["port"][0] == 1
    assert "previous run" in caplog.text


def test_continue_skips_everything(built, caplog):
    before = _tree(built["port"])
    runs = _rerun(built, built["args"], caplog, ["--continue"])
    rc, events = runs["port"]
    assert rc == 0 and events == runs["jax"][1]
    assert sum("up to date, skipped" in e for e in events) == 6
    assert _tree(built["port"]) == before


def test_start_finish_reruns_only_those_steps(built, tmp_path, caplog):
    wds = dict(zip(("jax", "port"), run_both(built["args"], tmp_path, "mb")))
    runs = _rerun(wds, built["args"], caplog,
                  ["--start", "component-cutter",
                   "--finish", "features-calculator"])
    rc, events = runs["port"]
    assert rc == 0 and events == runs["jax"][1]
    ran = [e.split("]")[0][1:] for e in events if e.endswith("started")]
    assert ran == ["matrix-builder", "component-cutter",
                   "features-calculator"]
    assert not (wds["port"] / "dist-matrix-calculator" / "SUCCESS").exists()
    assert_same_tree(wds["jax"], wds["port"])


@pytest.mark.parametrize("error", [torch.cuda.OutOfMemoryError, MemoryError])
def test_out_of_memory_maps_to_one_device_advice(tmp_path, monkeypatch,
                                                 caplog, error):
    from metafast_tpu_torch.tools import framework as fw

    class Boom(fw.get_tool("view")):
        def run_impl(self):
            raise error("CUDA out of memory. Tried to allocate 2.00 GiB")

    monkeypatch.setitem(fw._REGISTRY, "view", Boom)
    with caplog.at_level(logging.ERROR):
        assert cli.main(["-t", "view", "-k", "5", "-kf", "/nonexistent",
                         "-w", str(tmp_path), "--device", "cpu"]) == 1
    assert "run fewer samples per call" in caplog.text
    assert "--shards" not in caplog.text


def test_heatmap_without_matplotlib_names_it(built, tmp_path, monkeypatch,
                                             caplog):
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    (mat,) = (built["port"] / "matrices").glob("*_original_order.txt")
    with caplog.at_level(logging.ERROR):
        assert cli.main(["-t", "heatmap-maker", "-i", str(mat),
                         "--heatmap-file", str(tmp_path / "h.png"),
                         "-w", str(tmp_path), "--device", "cpu"]) == 1
    assert "'matplotlib'" in caplog.text
    assert not list(tmp_path.glob("*.png"))


def test_cuda_without_cuda_exits_nonzero(built, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["-k", str(K), "-i", *built["files"], "-w",
                     str(tmp_path), "--device", "cuda"]) != 0
    assert not list(tmp_path.rglob("*.kmers.bin"))
    assert not (tmp_path / "kmer-counter-many").exists()


# ---------------------------------------------------------------------------
# files carried across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["jax", "port"])
def test_kmers_bin_carried_across(built, tmp_path, source):
    """One package's kmer-counter output into the other's seq-builder
    gives the seq-builder output of the package that wrote it."""
    other = {"jax": (cli.main, ["--device", "cpu"]),
             "port": (jax_cli.main, [])}[source]
    src = built[source] / "kmer-counter-many"
    args = ["-t", "seq-builder", "-k", str(K), "-l", "100",
            "-i", str(src / "kmers" / "sample_1.kmers.bin")]
    assert _run(other[0], args, tmp_path, *other[1]) == 0
    got = (tmp_path / "sequences" / "sample_1.seq.fasta").read_bytes()
    want = (built[source] / "seq-builder-many" / "sequences" /
            "sample_1.seq.fasta").read_bytes()
    assert got == want


@pytest.mark.parametrize("source", ["jax", "port"])
def test_components_bin_carried_across(built, tmp_path, source):
    other = {"jax": (cli.main, ["--device", "cpu"]),
             "port": (jax_cli.main, [])}[source]
    wd = built[source]
    kb = [str(wd / "kmer-counter-many" / "kmers" / f"sample_{i}.kmers.bin")
          for i in range(3)]
    args = ["-t", "features-calculator", "-k", str(K),
            "-cm", str(wd / "component-cutter" / "components.bin"),
            "-ka", *kb]
    assert _run(other[0], args, tmp_path, *other[1]) == 0
    for i in range(3):
        for ext in ("vec", "breadth"):
            name = f"sample_{i}.{ext}"
            assert (tmp_path / "vectors" / name).read_bytes() == (
                wd / "features-calculator" / "vectors" / name).read_bytes()


# ---------------------------------------------------------------------------
# the port functions the tools stand on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threshold", [0, 3])
def test_load_kmers_bin_matches_jax(tmp_path, threshold):
    rng = np.random.default_rng(4)
    shared = rng.choice(1 << 40, 300, replace=False)
    files = []
    for i in range(2):
        own = rng.choice(1 << 40, 500, replace=False) + (i + 1) * (1 << 41)
        keys = np.concatenate([shared, own])
        counts = np.concatenate([rng.integers(16000, 32768, 300),
                                 rng.integers(0, 8, 500)])
        order = rng.permutation(len(keys))
        path = str(tmp_path / f"t{i}.kmers.bin")
        binfmt.write_kmers_bin(path, keys[order], counts[order])
        files.append(path)
    for fs in (files[:1], files):
        wk, wc = jax_api.load_kmers_bin(fs, threshold)
        gk, gc = api.load_kmers_bin(fs, threshold, "cpu")
        assert gk.dtype == torch.int64 and gc.dtype == torch.int32
        assert np.array_equal(gk.numpy(), wk) and np.array_equal(gc.numpy(), wc)
    assert (wc == 32767).sum() > 100 and wc.min() > threshold


def test_count_contig_kmers_on_read_back_fasta_matches_jax(tmp_path):
    """Sequences as component-cutter reads them back from a FASTA, with
    lowercase bases and N (which the JAX packer reads as T through the
    end of its 4-base group)."""
    rng = np.random.default_rng(8)
    fa = tmp_path / "mixed.fasta"
    with open(fa, "w") as fh:
        for i in range(60):
            alphabet = "ACGTacgtN" if i % 3 == 0 else "ACGTacgt"
            seq = "".join(rng.choice(list(alphabet), int(rng.integers(20, 300))))
            fh.write(f">{i}\n{seq[:70]}\n{seq[70:]}\n")
    seqs = list(iter_reads(str(fa)))
    assert any("N" in s for s in seqs) and any("a" in s for s in seqs)
    for min_len in (0, 100):
        wk, wc = jax_matrix.count_contig_kmers(seqs, 21, min_len=min_len)
        gk, gc = matrix.count_contig_kmers(seqs, 21, "cpu", min_len=min_len)
        assert np.array_equal(gk.numpy(), wk) and np.array_equal(gc.numpy(), wc)


def test_feature_vectors_threshold_and_selection_match_jax():
    """threshold > 0, and components cut to selected k-mers (one empty)."""
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(0, 1 << 40, 4000))
    counts = rng.integers(1, 9, len(keys)).astype(np.int32)
    comps = [np.sort(rng.choice(keys, n, replace=False)) for n in (50, 80, 30)]
    comps.append(np.unique(rng.integers(0, 1 << 40, 40)))
    selected = rng.choice(keys, 2000, replace=False)
    comps = [c[np.isin(c, selected)] for c in comps] + [np.empty(0, np.int64)]

    class HostComp:
        def __init__(self, kmers):
            self.kmers = kmers

    for thr in (0, 3):
        wv, wb = jax_matrix.feature_vectors([HostComp(c) for c in comps],
                                            keys, counts.astype(np.int64), thr)
        gv, gb = matrix.feature_vectors(
            [Component(torch.from_numpy(c), 0, 0) for c in comps],
            torch.from_numpy(keys), torch.from_numpy(counts), thr)
        assert np.array_equal(gv.numpy(), wv) and np.array_equal(gb.numpy(), wb)
        assert wv[0] > 0

"""The port's group-comparison tools against the JAX package's, on the CPU.

Three groups of three samples (A, B, C) share a backbone, each group a
marker region of its own.  Both CLIs run every tool in-process on the
same files (JAX on its CPU backend, the port with ``--device cpu``) and
the working directories must be equal byte for byte, as in
tests/test_torch_tools.py.  The markers make the chi-squared and
Mann-Whitney survivors and the pivot components non-empty; the tests
assert that they are.  unique-features and stats-features run in
tests/test_torch_group_pipelines.py.
"""

from pathlib import Path

import numpy as np
import pytest

from metafast_tpu import cli as jax_cli
from metafast_tpu.io import binfmt
from metafast_tpu_torch import cli
from torch_helpers import assert_same_tree, write_group_samples

K = 31
GROUPS = ["A"] * 3 + ["B"] * 3 + ["C"] * 3


def _jax(args, wd):
    assert jax_cli.main([*args, "-w", str(wd)]) == 0
    return wd


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Reads, their .kmers.bin files (the JAX counter's) and the JAX
    outputs that later tools take as input."""
    root = tmp_path_factory.mktemp("torch_group_tools")
    reads, genomes = write_group_samples(root, GROUPS, 16_000, 5_000,
                                         3_000, 12, seed=12)
    wd = _jax(["-t", "kmer-counter-many", "-k", str(K), "-i", *reads],
              root / "count")
    kb = [str(wd / "kmers" / f"{Path(r).stem}.kmers.bin") for r in reads]
    a, b, c = kb[0:3], kb[3:6], kb[6:9]
    stats = _jax(["-t", "stats-kmers", "-A", *a, "-B", *b], root / "stats")
    top = _jax(["-t", "top-stats-kmers", "-A", *a, "-B", *b, "-C", *c,
                "-n", "2000"], root / "top")
    pivots = stats / "kmers" / "filtered_groupA.kmers.bin"
    extracted = _jax(["-t", "component-extractor", "-k", str(K), "-i", *a,
                      "--pivot", str(pivots)], root / "extract")
    classes = root / "classes.tsv"
    classes.write_text("".join(f"{Path(r).stem}\t{'ABC'.index(g)}\n"
                               for r, g in zip(reads, GROUPS)))
    colored = _jax(["-t", "kmers-color", "-k", str(K), "-kf", *kb,
                    "--class", str(classes)], root / "color")

    # a reference (sample A_0's genome) and samtools-view lines of reads
    # mapped to it, 150M each, and one to a contig not in the reference
    rng = np.random.default_rng(13)
    ref = root / "ref.fasta"
    ref.write_bytes(b">chrA0\n" + genomes[0] + b"\n")
    sam = root / "reads.sam"
    with open(sam, "w") as fh:
        for i, pos in enumerate(sorted(rng.integers(1, len(genomes[0]) - 150,
                                                    400))):
            fh.write(f"r{i}\t0\tchrA0\t{pos}\t60\t150M\t*\t0\t0\tSEQ\tQUAL\n")
        fh.write("x0\t0\tchrX\t5\t60\t150M\n")
    frag = root / "fragment.fasta"
    frag.write_bytes(b">frag\n" + genomes[0][9_000:9_400] + b"\n")

    comps = extracted / "components.bin"
    assert binfmt.read_components_bin(str(comps))
    assert len(binfmt.read_kmers_bin(str(pivots))[0]) > 1000
    return dict(reads=reads, a=a, b=b, c=c, kb=kb, pivots=str(pivots),
                comps=str(comps), ref=str(ref), sam=str(sam),
                frag=str(frag), classes=str(classes),
                top_all=str(top / "kmers" / "all.kmers.bin"),
                top_ranks=str(top / "kmers" / "all_chi_squared_ranks.bin"),
                colored=str(colored / "colored-kmers" /
                            "colored_kmers.kmers.bin"))


def _case_args(case: str, g: dict) -> list[str]:
    """The tool of one case, then its arguments."""
    k = ["-k", str(K)]
    a, b, c = g["a"], g["b"], g["c"]
    colored = ["component-colored", *k, "-i", g["colored"]]
    return {
        "stats-kmers": ["stats-kmers", "-A", *a, "-B", *b],
        "stats-kmers-pmw0": ["stats-kmers", "-A", *a, "-B", *b,
                             "-pmw", "0", "-b", "2"],
        "stats-kmers-3": ["stats-kmers-3", "-A", *a, "-B", *b, "-C", *c],
        "bitset-stats-kmers-3": ["bitset-stats-kmers-3", "-A", *a, "-B", *b,
                                 "-C", *c, "-pchi2", "0.01"],
        "specific-kmers": ["specific-kmers", "-A", *a, "-B", *b, *c],
        "specific-kmers-3": ["specific-kmers-3", "-A", *a, "-B", *b,
                             "-C", *c, "-pmw", "0.2"],
        "top-stats-kmers": ["top-stats-kmers", "-A", *a, "-B", *b,
                            "-n", "500"],
        "top-stats-kmers-3": ["top-stats-kmers", "-A", *a, "-B", *b,
                              "-C", *c, "-n", "3000", "-b", "3"],
        "subset-specific": ["subset-specific", "-i", g["top_all"],
                            "-rk", g["top_ranks"], "-n", "700"],
        "component-extractor": ["component-extractor", *k, "-i", *a,
                                "--pivot", g["pivots"]],
        "component-extractor-depth3": ["component-extractor", *k,
                                       "-i", *a, *b, "--pivot", g["pivots"],
                                       "--depth", "3"],
        "component-paths": ["component-paths", *k, "-cf", g["comps"],
                            "--seq", g["reads"][0], "-a", "-l", "60"],
        "component-paths-numbers": ["component-paths", *k, "-cf", g["comps"],
                                    "--seq", *g["reads"][1:3],
                                    "-cm", "1", "-l", "100"],
        "comparison-script": ["comparison-script", *k, "-cf", g["comps"],
                              "-r", g["ref"], "-so", g["sam"]],
        "antibody-sequences-finder": ["antibody-sequences-finder", *k,
                                      "-d", "40", "--shift", "20",
                                      "-ff", g["frag"], "-i", g["reads"][0],
                                      "-b", "1"],
        "supergraph-sequence-builder": ["supergraph-sequence-builder", *k,
                                        "-i", *g["reads"][:4],
                                        "-sb", "1", "-l", "100"],
        "supergraph-sequence-builder-bp": ["supergraph-sequence-builder", *k,
                                           "-i", *g["reads"][3:5],
                                           "-bp", "5", "-sb", "0",
                                           "-l", "80"],
        "kmers-color": ["kmers-color", *k, "-kf", *g["kb"],
                        "--class", g["classes"], "--val"],
        "component-colored": colored,
        "component-colored-separate": [*colored, "--separate"],
        "component-colored-linear": [*colored, "--linear", "-comp", "2"],
        "component-colored-comp": [*colored, "-comp", "1", "-perc", "0.7"],
    }[case]


CASES = ["stats-kmers", "stats-kmers-pmw0", "stats-kmers-3",
         "bitset-stats-kmers-3", "specific-kmers", "specific-kmers-3",
         "top-stats-kmers", "top-stats-kmers-3", "subset-specific",
         "component-extractor", "component-extractor-depth3",
         "component-paths", "component-paths-numbers", "comparison-script",
         "antibody-sequences-finder", "supergraph-sequence-builder",
         "supergraph-sequence-builder-bp", "kmers-color",
         "component-colored", "component-colored-separate",
         "component-colored-linear", "component-colored-comp"]

# what each tool must have found, so that the byte comparison is not one
# of empty files: (a file of the run, reader, least number of records)
NON_EMPTY = {
    "stats-kmers": ("kmers/filtered_groupA.kmers.bin", binfmt.read_kmers_bin,
                    1000),
    "stats-kmers-3": ("kmers/filtered_groupC.kmers.bin",
                      binfmt.read_kmers_bin, 1000),
    "specific-kmers": ("kmers/filtered_groupA.kmers.bin",
                       binfmt.read_kmers_bin, 1000),
    "top-stats-kmers": ("kmers/top_500_chi_squared_specific.kmers.bin",
                        binfmt.read_kmers_bin, 500),
    "component-extractor-depth3": ("components.bin",
                                   binfmt.read_components_bin, 1),
    "component-colored": ("colored-components/components_color_1.bin",
                          binfmt.read_components_bin, 1),
}


@pytest.mark.parametrize("case", CASES)
def test_group_tool_matches_jax(case, groups, tmp_path):
    args = ["-t", *_case_args(case, groups)]
    assert jax_cli.main([*args, "-w", str(tmp_path / "jax")]) == 0
    assert cli.main([*args, "-w", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    tree = assert_same_tree(tmp_path / "jax", tmp_path / "port")
    assert tree
    if case in NON_EMPTY:
        rel, read, least = NON_EMPTY[case]
        assert len(read(str(tmp_path / "port" / rel))[0]) >= least



@pytest.mark.parametrize("tool", ["stats-kmers", "stats-kmers-3"])
def test_empty_sample_matches_jax(tool, tmp_path):
    """Group A's first sample is empty (0 records), so its column of the
    depth-normalised counts is NaN (0 * x / 0) in both packages: the
    port's Mann-Whitney must rank NaN as the JAX package does, after
    every number, and write the same files."""
    groups = ["A"] * 4 + ["B"] * 4
    if tool == "stats-kmers-3":
        groups += ["C"] * 3
    reads, _ = write_group_samples(tmp_path, groups, 12_000, 4_000, 2_500,
                                   10, seed=5)
    wd = _jax(["-t", "kmer-counter-many", "-k", str(K), "-i", *reads],
              tmp_path / "count")
    kb = [str(wd / "kmers" / f"{Path(r).stem}.kmers.bin") for r in reads]
    binfmt.write_kmers_bin(kb[0], np.empty(0, np.int64),
                           np.empty(0, np.int16))
    args = ["-t", tool, "-A", *kb[:4], "-B", *kb[4:8]]
    if tool == "stats-kmers-3":
        args += ["-C", *kb[8:]]
    _jax(args, tmp_path / "jax")
    assert cli.main([*args, "-w", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    assert_same_tree(tmp_path / "jax", tmp_path / "port")
    # a NaN mean is above no other: the kept k-mers go to the last group
    last = "kmers/filtered_group" + "ABC"[len(set(groups)) - 1]
    keys, _ = binfmt.read_kmers_bin(str(tmp_path / "port" /
                                        f"{last}.kmers.bin"))
    assert len(keys) > 1000

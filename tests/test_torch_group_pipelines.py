"""Pipelines 2 and 5 (unique-features, stats-features) and the wizard of
the port against the JAX package's, on the CPU.

A positive and a negative group of three samples share a backbone, the
positive one a marker region of its own.  Both CLIs run each pipeline
end to end from the reads (JAX on its CPU backend, the port with
``--device cpu``); the working directories must be equal byte for byte,
and the survivors and components must not be empty.
"""

import functools
import re

import pytest

from metafast_tpu import cli as jax_cli
from metafast_tpu import gui as jax_gui
from metafast_tpu.io import binfmt
from metafast_tpu_torch import cli, gui
from torch_helpers import assert_same_tree, write_group_samples

run_port_wizard = gui.run_wizard

K = 31


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_group_pipelines")
    files, _ = write_group_samples(root, ["pos"] * 3 + ["neg"] * 3, 16_000,
                                   5_000, 3_000, 12, seed=14)
    return dict(pos=files[:3], neg=files[3:])


PIPELINES = {
    "stats-features": ([], "stats-kmers/kmers/filtered_groupA.kmers.bin"),
    "stats-features-split": (["-pmw", "0.2", "--split"],
                             "stats-kmers/kmers/filtered_groupA.kmers.bin"),
    "unique-features": (["--min-samples", "2", "--max-samples", "3"],
                        "unique-kmers-multi/kmers/filtered_2.kmers.bin"),
}


@pytest.mark.parametrize("case", sorted(PIPELINES))
def test_group_pipeline_matches_jax(case, reads, tmp_path):
    extra, survivors = PIPELINES[case]
    args = ["-t", case.removesuffix("-split"), "-k", str(K),
            "-pos", *reads["pos"], "-neg", *reads["neg"], *extra]
    assert jax_cli.main([*args, "-w", str(tmp_path / "jax")]) == 0
    assert cli.main([*args, "-w", str(tmp_path / "port"),
                     "--device", "cpu"]) == 0
    tree = assert_same_tree(tmp_path / "jax", tmp_path / "port")
    port = tmp_path / "port"
    assert len(binfmt.read_kmers_bin(str(port / survivors))[0]) > 1000
    comps = binfmt.read_components_bin(
        str(port / "component-extractor" / "components.bin"))
    assert comps and sum(len(c[0]) for c in comps) > 1000
    vectors = [r for r in tree if r.startswith("features-calculator/vectors/")
               and r.endswith(".vec")]
    assert len(vectors) == 3
    assert any(r.startswith("comp2seq/") and r.endswith(".fasta")
               for r in tree)


def _wizard(run_wizard, answers, lines):
    """run_wizard with scripted answers; its printed lines into ``lines``."""
    it = iter(answers)

    def answer(prompt):
        lines.append(prompt)
        return next(it)

    return run_wizard(["--device", "cpu"], input_fn=answer,
                      print_fn=lambda s="": lines.append(str(s)))


def test_wizard_matches_jax(reads, tmp_path, monkeypatch):
    """Both wizards, driven by the same answers (a tool by number, its
    parameters, a work dir), print the same lines apart from the module
    name and write the same work dir; --gui reaches the port's."""
    names = sorted(jax_cli.fw.all_tools())
    answers = [str(names.index("top-stats-kmers") + 1),
               " ".join(reads["pos"]), " ".join(reads["neg"]), "",
               "", "50", "", "", "wd", "y"]
    printed = {}
    for side, run_wizard in (("jax", jax_gui.run_wizard),
                             ("port", gui.run_wizard)):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        printed[side] = []
        assert _wizard(run_wizard, answers, printed[side]) == 0
    mask = re.compile(r"<function \S+ at 0x[0-9a-f]+>")
    assert [mask.sub("<function>", ln) for ln in printed["port"]] == [
        mask.sub("<function>", ln).replace("metafast_tpu.cli",
                                           "metafast_tpu_torch.cli")
        for ln in printed["jax"]]
    assert any("-t top-stats-kmers" in ln for ln in printed["port"])
    tree = assert_same_tree(tmp_path / "jax" / "wd", tmp_path / "port" / "wd")
    assert "kmers/top_50_chi_squared_specific.kmers.bin" in tree

    # --gui on the launcher starts the wizard; a required parameter left
    # empty twice aborts, and "n" runs nothing
    monkeypatch.chdir(tmp_path)
    for answers, rc in ((["comp2seq", "", "", ""], 1),
                        (["comp2seq", "5", "x.bin", "", "gw", "n"], 0)):
        it = iter(answers)
        monkeypatch.setattr(gui, "run_wizard", functools.partial(
            run_port_wizard, input_fn=lambda _: next(it),
            print_fn=lambda s="": None))
        assert cli.main(["--gui", "--device", "cpu"]) == rc
    assert not (tmp_path / "gw").exists()

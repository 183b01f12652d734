"""The check that decides ``correct``: the plain reference against the
program run on the CPU, its control, and runs with the timed path broken
underneath, each of which must come out not correct."""

import numpy as np
import pytest

from portbench import control
from portbench.gen.community import generate
from portbench.harness import compare, runner


def _run(cell, seed, **kw):
    return runner.run(cell, seed, 0.0, False, "cpu", log=lambda m: None,
                      **kw)


def test_program_equals_reference(tiny_cell, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    res = _run(tiny_cell, 2**32 + 15)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"


def test_control_fails(tiny_cell):
    """The control: the reference under a 32-bit key (the next integer
    type below the configuration's 2k-bit keys)."""
    tool, params = tiny_cell.tool, tiny_cell.config["params"]
    samples = generate(tiny_cell.traffic, 21)
    want = tool.expected(samples, params, "cpu", {})
    with control.narrow_keys():
        ctrl = tool.expected(samples, params, "cpu", {})
    numbers = tool.compare(ctrl, want)
    assert numbers["table_rows_off"] > 0
    assert not compare.passed(numbers, tool.LIMITS)
    # the plain reference is itself again once the control is done
    assert tool.compare(tool.expected(samples, params, "cpu", {}),
                        want)["table_rows_off"] == 0


def _half_reads(api):
    orig = api.parse_reads

    def half(path, min_len=0):
        codes, lengths, total, skipped = orig(path, min_len)
        n = len(lengths) // 2
        return codes[: int(lengths[:n].sum())], lengths[:n], total, skipped
    return "parse_reads", half


def _unchanged_state(count):
    def add(self, w0, w1, w2, vm, lengths):
        self._add_total(lengths)        # the step leaves the table as it was
    return "add_stream3_device", add


def _altered_answer(binfmt):
    orig = binfmt.write_kmers_bin

    def altered(path, keys, counts, threshold=None):
        counts = np.array(counts, copy=True)
        counts[len(counts) // 2] += 1
        return orig(path, keys, counts, threshold)
    return "write_kmers_bin", altered


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state",
                                   "altered_answer"])
def test_broken_path_is_not_correct(fault, tiny_cell, tmp_path, monkeypatch):
    """Each fault the cell can have (it has no exchange between chips)."""
    from metafast_tpu_torch import api
    from metafast_tpu_torch.io import binfmt
    from metafast_tpu_torch.ops import count

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    target, make = {"half_batch": (api, _half_reads),
                    "unchanged_state": (count.KmerCounter, _unchanged_state),
                    "altered_answer": (binfmt, _altered_answer)}[fault]
    monkeypatch.setattr(target, *make(target))
    res = _run(tiny_cell, 33)
    assert not res["correct"], res["checks"]
    if fault == "unchanged_state":      # no k-mers: the job cannot finish
        assert res["failed"] == res["attempted"]
    else:                               # a job that finishes, and is wrong
        assert res["failed"] == 0
        assert res["checks"]["table_rows_off"]["value"] > 0


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "metafast_tpu_torch_x",
                        types.ModuleType("metafast_tpu_torch_x"))
    assert runner.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "metafast_tpu.api",
                        types.ModuleType("metafast_tpu.api"))
    assert runner.forbidden_modules() == ["metafast_tpu.api"]


@pytest.mark.cuda
def test_harness_on_the_card(tiny_cell, card, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    res = runner.run(tiny_cell, 91, 0.0, True, card, log=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0

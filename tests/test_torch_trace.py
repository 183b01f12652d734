"""Spans and counters of the port (metafast_tpu_torch/utils/trace.py): off
without a profiler, on under one, in the job's log, in the profiler's
trace and in the byte counters; and the spill warning of kmer-counter."""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_helpers import cuda_device  # noqa: F401
from torch_helpers import (PATH_CASES, assert_same_tree,
                           check_kmer_counter_copies, path_table,
                           write_group_samples, write_samples)

from metafast_tpu_torch import api as tapi
from metafast_tpu_torch import cli
from metafast_tpu_torch.graph import components as comp
from metafast_tpu_torch.graph import pivot
from metafast_tpu_torch.tools import framework as fw
from metafast_tpu_torch.utils import trace
from metafast_tpu_torch.utils.kmers import sequence_kmers

ARGS = ["-k", "31", "-b1", "100", "-b2", "3000", "--device", "cpu",
        "--finish", "dist-matrix-calculator"]
LINE = re.compile(r"\[([^\]]+)\] (started|done in [0-9.]+s)$")

# the spans a matrix-builder job reaches, each inside a step
SPANS = {
    "count.parse", "count.layout", "count.merge", "count.to_host",
    "contigs.chain", "contigs.to_host", "contigs.assemble",
    "components.recount", "components.to_host", "components.level",
    "components.labels", "components.bookkeeping",
    "contigs.load", "features.load", "features.vectors",
    "features.to_host", "matrix.bray_curtis",
    "read.kmers_bin", "read.fasta", "read.components", "read.vec",
    "write.kmers_bin", "write.stat", "write.distribution", "write.fasta",
    "write.components", "write.components_stat", "write.vec",
    "write.matrix",
}
# the step files, each written inside a write span
STEP_FILES = ("kmer-counter-many/kmers/*.kmers.bin",
              "kmer-counter-many/stats/*.stat.txt",
              "seq-builder-many/*/distribution",
              "seq-builder-many/sequences/*.seq.fasta",
              "component-cutter/components.bin",
              "component-cutter/components-stat-*.txt",
              "features-calculator/vectors/*.vec",
              "features-calculator/vectors/*.breadth",
              "matrices/dist_matrix_*_original_order.txt")


def _records(log: Path):
    """(name, started?) of every started / done line of a job's log."""
    out = []
    for line in log.read_text().splitlines():
        m = LINE.search(line)
        if m:
            out.append((m[1], m[2] == "started"))
    return out


def _nest(records):
    """(name, depth) of every span, in order of its start; asserts that
    every done line closes the innermost open span of its name."""
    out, stack = [], []
    for name, started in records:
        if started:
            out.append((name, len(stack)))
            stack.append(name)
        else:
            assert stack and stack[-1] == name, (name, stack)
            stack.pop()
    assert not stack, stack
    return out


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """One matrix-builder job without the profiler, one under it."""
    root = tmp_path_factory.mktemp("torch_trace")
    files = write_samples(root, 3, 30_000, 12_000, 12, seed=11)
    args = ["-i", *files, *ARGS]
    trace.reset()
    assert cli.main(args + ["-w", str(root / "off")]) == 0
    off_counts = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert cli.main(args + ["-w", str(root / "on")]) == 0
    on_counts = trace.counters()
    trace.reset()
    prof.export_chrome_trace(str(root / "trace.json"))
    events = json.loads((root / "trace.json").read_text())["traceEvents"]
    marks = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    return dict(off=root / "off", on=root / "on", off_counts=off_counts,
                on_counts=on_counts, marks=marks)


def test_off_span_is_one_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    assert trace.span("a") is trace.span("b", "file") is trace.step("c")
    trace.reset()
    trace.count("written_bytes", 5)
    trace.d2h(torch.ones(3))
    trace.h2d(torch.device("cuda"), np.ones(3))
    assert trace.counters() == {}
    with trace.span("x"):
        pass


def test_on_span_counts_only_what_moves():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        trace.d2h(torch.ones(3))                         # on the host
        trace.h2d(torch.device("cpu"), np.ones(3))       # to the host
        trace.h2d(torch.device("cuda"), np.ones(3), np.ones(2, np.int32))
        trace.count("written_bytes", 7)
    assert trace.counters() == {"d2h_bytes": 0, "h2d_bytes": 32,
                                "written_bytes": 7}
    trace.reset()


def test_untraced_job_logs_steps_only(jobs):
    names = {name for name, _ in _records(jobs["off"] / "log")}
    assert names and names <= set(fw.all_tools())
    assert jobs["off_counts"] == {}


def test_traced_job_nests_spans_below_the_same_steps(jobs):
    off = _nest(_records(jobs["off"] / "log"))
    on = _nest(_records(jobs["on"] / "log"))
    assert [n for n, d in on if d <= 1] == [n for n, d in off if d <= 1]
    assert all(d >= 2 for n, d in on if "." in n)
    assert [n for n, _ in on if "." not in n] == [n for n, _ in off]
    assert {n for n, _ in on if "." in n} == SPANS


def test_traced_job_spans_and_steps_in_the_trace(jobs):
    on = _nest(_records(jobs["on"] / "log"))
    spans = {n for n, _ in on if "." in n}
    steps = {n for n, _ in on if "." not in n}
    assert {"mf." + n for n in spans} <= jobs["marks"]
    assert {"mf.step." + n for n in steps} <= jobs["marks"]


def test_written_bytes_are_the_step_files(jobs):
    files = {p for pattern in STEP_FILES for p in jobs["on"].glob(pattern)}
    assert len(files) >= 9
    assert jobs["on_counts"]["written_bytes"] == sum(
        p.stat().st_size for p in files)
    # the CPU run copies nothing between host and device
    assert jobs["on_counts"].get("d2h_bytes", 0) == 0
    assert jobs["on_counts"].get("h2d_bytes", 0) == 0


def test_span_that_raises_logs_no_done_line(tmp_path):
    logger = cli._setup_logging(tmp_path, False)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with pytest.raises(ValueError), trace.span("x.y"):
                raise ValueError
            with trace.span("x.z"):
                pass
    finally:
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    assert _records(tmp_path / "log") == [("x.y", True), ("x.z", True),
                                          ("x.z", False)]


def test_spilled_table_is_reported(tmp_path, monkeypatch):
    files = write_samples(tmp_path, 1, 20_000, 0, 10, seed=5)
    args = ["-t", "kmer-counter", "-k", "31", "-i", *files,
            "--device", "cpu"]
    assert cli.main(args + ["-w", str(tmp_path / "whole")]) == 0
    monkeypatch.setattr(tapi, "card_spill", lambda device, chunk=0: 64)
    assert cli.main(args + ["-w", str(tmp_path / "spilled")]) == 0
    whole = (tmp_path / "whole" / "log").read_text()
    spilled = (tmp_path / "spilled" / "log").read_text()
    assert "spill" not in whole
    assert re.search(r"WARN\S* +\[kmer-counter\] the k-mer table reached "
                     r"the card's spill threshold and moved to host RAM 1 "
                     r"time", spilled)
    (a,), (b,) = ((tmp_path / d / "kmers").glob("*.kmers.bin")
                  for d in ("whole", "spilled"))
    assert a.read_bytes() == b.read_bytes()


def test_spilled_count_reads_files_stats(tmp_path, monkeypatch):
    files = write_samples(tmp_path, 1, 20_000, 0, 10, seed=5)
    keys, counts, stats = tapi.count_reads_files(files, 31, "cpu")
    assert "spills" not in stats
    monkeypatch.setattr(tapi, "card_spill", lambda device, chunk=0: 64)
    skeys, scounts, sstats = tapi.count_reads_files(files, 31, "cpu")
    assert sstats.pop("spills") == 1 and sstats == stats
    assert torch.equal(keys, skeys) and torch.equal(counts, scounts)


def test_kmer_counter_copies_back_the_histogram_not_the_table(
        tmp_path, monkeypatch):
    """kmer-counter's copies back, its tensors counted as if they lay on
    the card."""
    monkeypatch.setattr(trace, "d2h", lambda *ts: trace.count(
        "d2h_bytes", sum(t.nbytes for t in ts)))
    check_kmer_counter_copies(tmp_path, torch.device("cpu"))


# the spans pipeline 5 adds, each in its step of stats-features
SF_SPANS = {
    "stats.presence.union": "stats-kmers",
    "stats.presence.groups": "stats-kmers",
    "stats.chi2": "stats-kmers",
    "stats.mw": "stats-kmers",
    "extract.load": "component-extractor",
    "pivot.index": "component-extractor",
    "pivot.traverse": "component-extractor",
    "features.select": "features-calculator",
}


@pytest.fixture(scope="module")
def sf_jobs(tmp_path_factory):
    """One stats-features job without the profiler, one under it."""
    root = tmp_path_factory.mktemp("torch_trace_sf")
    files, _ = write_group_samples(root, ["pos"] * 3 + ["neg"] * 3, 16_000,
                                   5_000, 3_000, 12, seed=14)
    args = ["-t", "stats-features", "-k", "31", "-pos", *files[:3],
            "-neg", *files[3:], "--device", "cpu"]
    trace.reset()
    assert cli.main(args + ["-w", str(root / "off")]) == 0
    off_counts = trace.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert cli.main(args + ["-w", str(root / "on")]) == 0
    on_counts = trace.counters()
    trace.reset()
    prof.export_chrome_trace(str(root / "trace.json"))
    events = json.loads((root / "trace.json").read_text())["traceEvents"]
    marks = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    return dict(off=root / "off", on=root / "on", off_counts=off_counts,
                on_counts=on_counts, marks=marks)


def _steps_of(records):
    """(span, its enclosing depth-1 step) of every span of a job's log."""
    out, stack = [], []
    for name, started in records:
        if started:
            if "." in name and len(stack) >= 2:
                out.append((name, stack[1]))
            stack.append(name)
        else:
            stack.pop()
    return out


def test_stats_features_spans_nest_in_their_steps(sf_jobs):
    on = _nest(_records(sf_jobs["on"] / "log"))
    assert all(d >= 2 for n, d in on if "." in n)
    found = _steps_of(_records(sf_jobs["on"] / "log"))
    for span, step in SF_SPANS.items():
        assert (span, step) in found, span
        assert {s for n, s in found if n == span} == {step}, span
    assert {"mf." + n for n in SF_SPANS} <= sf_jobs["marks"]
    for name in ("stats_keys", "stats_survivors", "pivot_kmers",
                 "pivot_index_keys"):
        assert sf_jobs["on_counts"][name] > 0, name
    assert (sf_jobs["on_counts"]["stats_survivors"]
            < sf_jobs["on_counts"]["stats_keys"])


def test_untraced_stats_features_job_logs_no_span(sf_jobs):
    off = _records(sf_jobs["off"] / "log")
    assert not [n for n, _ in off if "." in n]
    assert sf_jobs["off_counts"] == {}
    # the profiler changes no output file
    assert_same_tree(sf_jobs["off"], sf_jobs["on"])


@pytest.mark.parametrize(
    "on_card", [False, pytest.param(True, marks=pytest.mark.cuda)])
def test_traced_depth1_extraction_counts_its_index(on_card, request):
    """A traced depth-1 extraction counts the keys it indexed on the
    device; on the card also the keys' upload and the two int32 tables'
    copy back (a tensor on the CPU moves nothing)."""
    device = (request.getfixturevalue("cuda_device") if on_card
              else torch.device("cpu"))
    rng = np.random.default_rng(9)
    keys = np.unique(np.concatenate([
        sequence_kmers("".join(rng.choice(list("ACGT"), 4_000)), 31)
        for _ in range(2)]))
    counts = rng.integers(2, 9, len(keys))
    pivots = rng.choice(keys, 50, replace=False)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        comps = pivot.split_around_pivot(keys, counts, 31, pivots,
                                         device=device)
    got = trace.counters()
    trace.reset()
    assert comps
    assert got["pivot_index_keys"] == len(keys)
    if on_card:
        assert got["d2h_bytes"] == 2 * 4 * 4 * len(keys)
        assert got["h2d_bytes"] == 8 * len(keys)
    else:
        assert got.get("d2h_bytes", 0) == got.get("h2d_bytes", 0) == 0


@pytest.mark.parametrize("case,on_card", [
    ("climb_compacts", False), ("empty", False),
    pytest.param("climb_compacts", True, marks=pytest.mark.cuda)])
def test_traced_split_components_counts_its_grouped_rows(case, on_card,
                                                         request, monkeypatch):
    """A traced split_components counts the rows it grouped on the device,
    the sum of the active rows over its levels (0 without a level); on
    the card it copies back only the emitted groups' sizes, weights and
    first keys, and uploads nothing."""
    device = (request.getfixturevalue("cuda_device") if on_card
              else torch.device("cpu"))
    b1, b2, paths = PATH_CASES["climb_compacts"]
    keys, counts = path_table(paths) if case != "empty" else (
        np.empty(0, np.int64), np.empty(0, np.int32))
    active_rows = []
    labels = comp.connected_labels

    def spy(nbr, active):
        active_rows.append(int(active.sum()))
        return labels(nbr, active)

    monkeypatch.setattr(comp, "connected_labels", spy)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        comps = comp.split_components(torch.from_numpy(keys).to(device),
                                      torch.from_numpy(counts).to(device),
                                      31, b1, b2)
    got = trace.counters()
    trace.reset()
    assert got.get("components_grouped_keys", 0) == sum(active_rows)
    # the climb's levels: the table, then its two oversized paths at
    # thresholds 2 and 3, then the climbing path's count-4 k-mers
    assert active_rows == ([] if case == "empty" else [1220, 220, 218, 115])
    assert len(comps) == (0 if case == "empty" else 46)
    if on_card:
        assert got["d2h_bytes"] == 3 * 8 * len(comps)
        assert "h2d_bytes" not in got
    else:
        assert got.get("d2h_bytes", 0) == got.get("h2d_bytes", 0) == 0

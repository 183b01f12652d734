"""The stats-features tool module (portbench/tools/stats_features.py) and
the per-layer metrics of its cell: the job's arguments, its outputs read
back, and the readers of the program's new spans and counter, off the
profiler, on a program without them, and on a traced CPU run of a
test-size cell."""

import json
from pathlib import Path

import pytest

from portbench.gen.community import Traffic
from portbench.harness import cells, runner
from portbench.harness.runner import Job, Record
from portbench.harness.steplog import Span
from portbench.tools import stats_features as tool

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "sf_hmp.gut_oral8"
NEW = [m["name"] for m in BENCH["per_layer"] if CELL in m["workloads"]]
CONFIG = json.loads((ROOT / "portbench" / "configs" / "sf_hmp.json")
                    .read_text())
TINY_GROUPS = Path(__file__).with_name("tiny_groups.json")


def _read(name, rec):
    return cells._reader(name)(rec)


def test_cell_resolves_to_the_tool():
    cell = cells.load(CELL)
    assert cell.chips == 1 and cell.tool is tool
    assert [m.name for m in cell.per_layer] == NEW and len(NEW) == 9
    assert cell.traffic.n_sites == 2 and cell.traffic.samples_per_site == 4


def test_argv_groups_files_by_site():
    files = [f"/r/site{s}_s{j}_R{m}.fastq" for s in (0, 1) for j in range(4)
             for m in (1, 2)]
    args = tool.argv(CONFIG, files, "/w", "cuda")
    pos, neg = args.index("-pos"), args.index("-neg")
    assert args[:pos] == ["-t", "stats-features", "-k", "31", "-b", "1",
                          "-pchi2", "0.05", "-pmw", "0.05"]
    assert args[pos + 1:neg] == [f for f in files if "/site1_" in f]
    assert args[neg + 1:neg + 9] == [f for f in files if "/site0_" in f]
    assert args[neg + 9:] == ["-w", "/w", "--device", "cuda"]


def test_read_job_raises_on_a_missing_file(tmp_path):
    with pytest.raises(OSError):
        tool.read_job(tmp_path, ["site0_s0", "site1_s0"])


def _job(with_new=True):
    sp = [Span("stats-features", 0, 0.0, 10.0, 10.0)]
    for i, step in enumerate(("kmer-counter-posneg", "stats-kmers",
                              "component-extractor", "features-calculator",
                              "comp2seq")):
        sp.append(Span(step, 1, 2.0 * i, 2.0 * i + 2, 2.0))
    sp += [Span("count.parse", 3, 0.0, 0.5, 0.5),
           Span("read.kmers_bin", 2, 2.0, 2.1, 0.1)]
    if with_new:
        sp += [Span("stats.presence.union", 2, 2.1, 2.5, 0.4),
               Span("stats.presence.groups", 2, 2.5, 2.8, 0.3),
               Span("stats.chi2", 2, 2.8, 3.0, 0.2),
               Span("stats.mw", 2, 3.0, 3.6, 0.6),
               Span("extract.load", 2, 4.0, 4.2, 0.2),
               Span("pivot.index", 3, 4.2, 4.5, 0.3),
               Span("pivot.traverse", 3, 4.5, 5.2, 0.7),
               Span("features.select", 2, 6.0, 6.9, 0.9),
               Span("features.select", 3, 8.0, 8.1, 0.1)]   # comp2seq's
    return Job(None, 0, 10.0, 0.0, 0, spans=sp,
               steps={"stats-kmers": 2.0, "component-extractor": 2.0})


def test_readers_of_the_new_spans(monkeypatch):
    from metafast_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_counts", {"stats_keys": 4_000_000_000})
    rec = Record([_job(), _job()], 20.0, 0)
    want = {"stats.step_s": 2.0, "stats.presence_s": 0.7,
            "stats.chi2_s": 0.2, "stats.mw_s": 0.6,
            "stats.ns_per_key": 1.0, "extract.step_s": 2.0,
            "extract.index_s": 0.3, "extract.traverse_s": 0.7,
            "features.select_s": 0.9}
    assert set(want) == set(NEW)
    for name, v in want.items():
        assert _read(name, rec) == pytest.approx(v), name


def test_readers_fall_silent_without_the_new_spans(monkeypatch):
    """Off the profiler, and on a traced program that lacks the spans and
    the counter (the parent's), the span and counter metrics read
    nothing; the step records are the launcher's own."""
    from metafast_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "_counts", {"d2h_bytes": 10})
    old = Record([_job(with_new=False)], 10.0, 0)
    monkeypatch.setattr(trace, "_counts", {})
    off = _job()
    off.spans = [s for s in off.spans if "." not in s.name]
    for rec in (old, Record([off], 10.0, 0), Record([], 10.0, 0)):
        for name in NEW:
            if name not in ("stats.step_s", "extract.step_s"):
                assert _read(name, rec) is None, name


def test_traced_run_reads_every_new_metric(tmp_path, monkeypatch):
    """A traced run of a test-size cell of sf_hmp on the CPU is correct
    and reports all nine."""
    from metafast_tpu_torch.utils import trace

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(trace, "_counts", {})
    cell = cells.Cell("tiny_sf", 1, CONFIG, Traffic.load(TINY_GROUPS), [],
                      [cells.Metric(n, "x", cells._reader(n)) for n in NEW])
    res = runner.run(cell, 2**33 + 7, 0.0, True, "cpu", log=lambda m: None)
    assert res["correct"], res["checks"]
    assert all(c["value"] == 0 for c in res["checks"].values())
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == set(NEW)
    assert all(v > 0 for v in got.values()), got

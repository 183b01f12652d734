"""The readers of the program's own spans and counters (harness/spans.py
and the metrics that use it), on a synthetic record and on a traced run
of a test-size cell on the CPU."""

import json

import pytest

from portbench.harness import cells, runner
from portbench.harness.runner import Job, Record
from portbench.harness.steplog import Span

from .conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = [m["name"] for m in BENCH["per_layer"]
       if "mb_defaults.deep2" in m["workloads"]]


def _job(rc=0):
    """A job of 10 s: each step 2 s, with spans inside."""
    sp = [Span("matrix-builder", 0, 0.0, 10.0, 10.0)]
    for i, step in enumerate(("kmer-counter-many", "seq-builder-many",
                              "component-cutter", "features-calculator",
                              "dist-matrix-calculator")):
        sp.append(Span(step, 1, 2.0 * i, 2.0 * i + 2, 2.0))
    sp += [Span("kmer-counter", 2, 0.0, 1.0, 1.0),
           Span("count.parse", 3, 0.0, 0.5, 0.5),
           Span("count.layout", 3, 0.5, 0.6, 0.1),
           Span("count.merge", 3, 0.6, 0.8, 0.2),
           Span("write.kmers_bin", 3, 0.8, 0.9, 0.1),
           Span("kmer-counter", 2, 1.0, 2.0, 1.0),
           Span("count.parse", 3, 1.0, 1.5, 0.5),
           Span("read.kmers_bin", 3, 2.0, 2.2, 0.2),
           Span("contigs.assemble", 3, 2.5, 3.0, 0.5),
           Span("write.fasta", 3, 3.0, 3.1, 0.1),
           Span("read.fasta", 2, 4.0, 4.3, 0.3),
           Span("components.recount", 2, 4.3, 4.8, 0.5),
           Span("count.parse", 3, 4.3, 4.4, 0.1),     # not counting's
           Span("count.merge", 3, 4.4, 4.7, 0.3),     # not counting's
           Span("components.level", 2, 4.8, 5.5, 0.7),
           Span("components.labels", 3, 4.8, 5.2, 0.4),
           Span("components.bookkeeping", 3, 5.2, 5.5, 0.3),
           Span("write.vec", 2, 7.0, 7.1, 0.1)]
    return Job(None, rc, 10.0, 0.0, 3, spans=sp)


def _read(name, rec):
    return cells._reader(name)(rec)


def test_span_readers():
    rec = Record([_job(), _job(), _job(rc=1)], 30.0, 0)
    want = {"counting.parse_s": 1.0, "counting.layout_s": 0.1,
            "counting.merge_s": 0.2, "contigs.assemble_s": 0.5,
            "components.labels_s": 0.4, "components.bookkeeping_s": 0.3,
            "files.read_s": 0.5, "files.write_s": 0.3}
    for name, v in want.items():
        assert _read(name, rec) == pytest.approx(v), name


def test_span_readers_without_spans():
    steps_only = _job()
    steps_only.spans = [s for s in steps_only.spans if "." not in s.name]
    for jobs in ([steps_only], [], [_job(rc=1)]):
        rec = Record(jobs, 10.0, 0)
        assert _read("counting.parse_s", rec) is None
        assert _read("files.write_s", rec) is None
    # spans recorded, none of the name: nothing spent there
    no_assembly = _job()
    no_assembly.spans = [s for s in no_assembly.spans
                         if s.name != "contigs.assemble"]
    assert _read("contigs.assemble_s", Record([no_assembly], 10.0, 0)) == 0.0


def test_counter_readers(monkeypatch):
    from metafast_tpu_torch.utils import trace

    rec = Record([_job(), _job(), _job(rc=1)], 30.0, 0)
    monkeypatch.setattr(trace, "_counts", {})
    for name in ("device.d2h_GB", "device.h2d_GB", "files.written_GB"):
        assert _read(name, rec) is None
    monkeypatch.setattr(trace, "_counts", {"d2h_bytes": 3_000_000_000,
                                           "written_bytes": 10})
    assert _read("device.d2h_GB", rec) == pytest.approx(1.5)
    assert _read("device.h2d_GB", rec) == 0.0
    assert _read("files.written_GB", rec) == pytest.approx(5e-9)
    assert _read("device.d2h_GB", Record([_job(rc=1)], 10.0, 0)) is None


def test_traced_run_reads_every_new_metric(tiny_cell, tmp_path,
                                           monkeypatch):
    """A traced run of the test-size cell on the CPU reports all eleven;
    the CPU moves nothing between host and device."""
    from metafast_tpu_torch.utils import trace

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(trace, "_counts", {})
    tiny_cell.per_layer = [cells.Metric(n, "x", cells._reader(n))
                           for n in NEW]
    res = runner.run(tiny_cell, 2**33 + 7, 0.0, True, "cpu",
                     log=lambda m: None)
    assert res["correct"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == set(NEW) and len(NEW) == 11
    assert got["device.d2h_GB"] == got["device.h2d_GB"] == 0.0
    for name in NEW:
        if name not in ("device.d2h_GB", "device.h2d_GB"):
            assert got[name] > 0, name

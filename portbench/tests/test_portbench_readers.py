"""The yardstick's arithmetic: K1's byte count, the trace reduction and
the step log."""

import json

import pytest

from portbench.harness import roofline, steplog, trace

K = 31
READ_LEN = 150
SLAB_CODES = 1 << 27


def test_k1_bound_of_a_full_slab():
    reads = SLAB_CODES // READ_LEN
    words = reads * -(-(READ_LEN - K + 1) // 16)
    words = -(-words // 256) * 256               # whole [C, 256] columns
    ms = roofline.bound_s(roofline.k1_bytes(words)) * 1e3
    assert ms == pytest.approx(0.3077, abs=5e-5)


LOG = """\
2026-01-02 03:04:05,100 INFO  running on cpu
2026-01-02 03:04:05,200 INFO  [matrix-builder] started
2026-01-02 03:04:05,300 INFO  [kmer-counter-many] started
2026-01-02 03:04:05,310 INFO  [kmer-counter] started
2026-01-02 03:04:06,310 INFO  [kmer-counter] done in 1.000s
2026-01-02 03:04:06,500 INFO  [kmer-counter-many] done in 1.200s
2026-01-02 03:04:06,600 INFO  [component-cutter] started
2026-01-02 03:04:08,600 INFO  [component-cutter] done in 2.000s
2026-01-02 03:04:08,700 INFO  [matrix-builder] done in 3.500s
"""


def test_step_log(tmp_path):
    p = tmp_path / "log"
    p.write_text(LOG)
    sp = steplog.spans(p)
    assert [(s.name, s.depth) for s in sp] == [
        ("matrix-builder", 0), ("kmer-counter-many", 1), ("kmer-counter", 2),
        ("component-cutter", 1)]
    assert steplog.step_seconds(sp) == {"kmer-counter-many": 1.2,
                                        "component-cutter": 2.0}
    assert sp[3].end - sp[3].start == pytest.approx(2.0)


def test_trace_summary(tmp_path):
    ev = [
        {"cat": "user_annotation", "name": "portbench.window", "ts": 1000,
         "dur": 10000},
        {"cat": "user_annotation", "name": "portbench.job0", "ts": 1000,
         "dur": 10000},
        {"cat": "kernel", "name": "void stream_extract_kernel<true>(...)",
         "ts": 2000, "dur": 1000},
        {"cat": "kernel", "name": "sort", "ts": 2500, "dur": 1500},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 9000, "dur": 500},
        {"cat": "kernel", "name": "late", "ts": 10500, "dur": 2000},
        {"cat": "cpu_op", "name": "aten::sort", "ts": 1500, "dur": 9000},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    wall0 = 100.0
    spans = [steplog.Span("kmer-counter-many", 1, wall0, wall0 + 0.005,
                          0.005),
             steplog.Span("component-cutter", 1, wall0 + 0.005,
                          wall0 + 0.01, 0.005)]
    s = trace.summarize(p, [(wall0, spans)])
    assert s.window_s == pytest.approx(0.01)
    # busy: [2000, 4000] + [9000, 9500] + [10500, 11000] (clipped)
    assert s.busy_s == pytest.approx(0.003)
    assert s.k1_launches == 1 and s.k1_device_s == pytest.approx(0.001)
    assert s.idle_gaps[0] == ["component-cutter", pytest.approx(0.005)]
    assert [g[0] for g in s.idle_gaps] == ["component-cutter",
                                           "kmer-counter-many",
                                           "component-cutter"]
    assert s.device_ops[0] == ["late", pytest.approx(0.002)]


def _reader(name):
    from portbench.harness import cells

    return cells._reader(name)


def test_metric_readers():
    from portbench.harness.runner import Job, Record

    jobs = [Job(None, 0, 10.0, 0.0, 21, steps={
        "kmer-counter-many": 3.0, "seq-builder-many": 3.5,
        "component-cutter": 2.5, "features-calculator": 0.5,
        "dist-matrix-calculator": 0.1}),
            Job(None, 0, 12.0, 0.0, 21, steps={
                "kmer-counter-many": 5.0, "seq-builder-many": 3.5,
                "component-cutter": 2.5, "features-calculator": 0.5,
                "dist-matrix-calculator": 0.1})]
    t = trace.TraceSummary(window_s=22.0, busy_s=2.2, k1_launches=2,
                           k1_device_s=2 * 0.0004)
    words = 7158272
    rec = Record(jobs, 22.0, 4_000_000_000, t, [(words, "stream3")] * 2)
    assert _reader("counting.step_s")(rec) == pytest.approx(4.0)
    assert _reader("features.step_s")(rec) == pytest.approx(0.6)
    assert _reader("launcher.other_s")(rec) == pytest.approx(0.4)
    assert _reader("device.idle_pct")(rec) == pytest.approx(90.0)
    assert _reader("device.peak_GB")(rec) == pytest.approx(4.0)
    assert _reader("k1.roofline_pct")(rec) == pytest.approx(
        100 * 0.30770 / 0.4, rel=1e-3)
    rec.k1_words = rec.k1_words[:1]     # a launch the trace lacks a twin of
    assert _reader("k1.roofline_pct")(rec) is None
    rec.trace = None
    assert _reader("device.idle_pct")(rec) is None

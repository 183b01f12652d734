"""The program's own spans and counters, as the per-layer metrics read them.

Under the profiler, ``metafast_tpu_torch.utils.trace`` logs spans in the
steps' own format, so a job's ``<workdir>/log`` nests them below its
steps (``steplog.spans``).  A span's name holds a dot (``count.parse``),
a step's never does (``kmer-counter``).  The same module sums byte
counters in the process, over the traced window only.

A reader returns None when the run recorded no span or counter at all
(tracing off, or a program without them), and otherwise 0.0 where
nothing matched.
"""

from __future__ import annotations


def _done(rec):
    return [j for j in rec.jobs if j.rc == 0 and j.spans]


def span_mean(rec, name: str, step: str | None = None) -> float | None:
    """Mean seconds a completed job spends in spans called ``name`` (every
    span whose name starts with it, where it ends in ``.``), counting only
    those inside its depth-1 step ``step`` when one is given."""
    done = _done(rec)
    if not any("." in s.name for j in done for s in j.spans):
        return None
    prefix = name.endswith(".")
    total = 0.0
    for j in done:
        outer = [s for s in j.spans if s.depth == 1 and s.name == step]
        for s in j.spans:
            if not (s.name.startswith(name) if prefix else s.name == name):
                continue
            if step is not None and not any(
                    o.start <= s.start and s.end <= o.end for o in outer):
                continue
            total += s.seconds
    return total / len(done)


def counter_mean_gb(rec, name: str) -> float | None:
    """Mean a completed job of the program's byte counter ``name``, in
    10^9 bytes."""
    try:
        from metafast_tpu_torch.utils import trace
    except ImportError:
        return None
    counts = trace.counters()
    done = [j for j in rec.jobs if j.rc == 0]
    if not counts or not done:
        return None
    return counts.get(name, 0) / len(done) / 1e9

"""The traced window: ``torch.profiler`` (CUPTI) over every job of the
window, read back from its Chrome trace.

The harness marks the window (``portbench.window``) and each job
(``portbench.job<i>``) with ``record_function``; the device's work is
every kernel, memcpy and memset event.  Idle gaps are labelled with the
launcher step that was running, taken from the job's step log, whose
wall clock is tied to the trace's clock at each job's mark.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from . import roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)   # [[name, s]]
    idle_gaps: list = field(default_factory=list)    # [[step, s]]
    k1_device_s: float = 0.0
    k1_launches: int = 0


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(path, jobs) -> TraceSummary:
    """``jobs``: per job of the window, (wall start in epoch s, its step
    spans from ``steplog.spans``)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    marks = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("portbench.")}
    w0, w1 = marks["portbench.window"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    clipped = [(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev]
    busy = _merged([(a, b) for a, b in clipped if b > a])
    by_name: dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    k1 = [e for e in dev if e.get("cat") == "kernel"
          and roofline.K1_KERNEL in e["name"]]

    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    labelled = [[_label(marks, jobs, (a + b) / 2), (b - a) / 1e6]
                for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]]
    return TraceSummary(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        device_ops=[[n[:160], s / 1e6] for n, s in sorted(
            by_name.items(), key=lambda x: -x[1])[:TOP]],
        idle_gaps=labelled,
        k1_device_s=sum(e["dur"] for e in k1) / 1e6,
        k1_launches=len(k1))


def _label(marks, jobs, t_us: float) -> str:
    """The innermost step running at trace time ``t_us``."""
    for i, (wall0, spans) in enumerate(jobs):
        a, b = marks.get(f"portbench.job{i}", (None, None))
        if a is None or not a <= t_us <= b:
            continue
        wall = wall0 + (t_us - a) / 1e6
        inner = [s for s in spans if s.start <= wall <= s.end]
        if not inner:
            return "launcher"
        return max(inner, key=lambda s: s.depth).name
    return "harness"

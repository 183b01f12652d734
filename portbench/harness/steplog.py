"""The launcher's step records, read from a job's ``<workdir>/log``.

Every step of the tool framework logs ``[<step>] started`` when it begins
and ``[<step>] done in <s>s`` when it ends (host clock around a step that
ends on host data and files).  Steps nest: the tool (depth 0), its steps
(depth 1), their per-sample steps (depth 2).
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass
from pathlib import Path

_LINE = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3}) \S+\s+"
                   r"\[([^\]]+)\] (started|done in ([0-9.]+)s)$")


@dataclass
class Span:
    name: str
    depth: int
    start: float        # epoch seconds (the log's local time, ms)
    end: float
    seconds: float      # the step's own "done in"


def spans(path) -> list[Span]:
    """Every finished step of one log, in order of its start."""
    out, stack = [], []
    for line in Path(path).read_text().splitlines():
        m = _LINE.match(line)
        if not m:
            continue
        stamp = time.mktime(time.strptime(m[1], "%Y-%m-%d %H:%M:%S")) \
            + int(m[2]) / 1000
        if m[4] == "started":
            stack.append((m[3], stamp, len(out)))
            out.append(None)
            continue
        while stack and stack[-1][0] != m[3]:
            stack.pop()                 # a step that never finished
        if not stack:
            continue
        name, start, slot = stack.pop()
        out[slot] = Span(name, len(stack), start, stamp, float(m[5]))
    return [s for s in out if s is not None]


def step_seconds(sp: list[Span]) -> dict[str, float]:
    """Seconds per step of the tool (depth 1), summed by name."""
    out: dict[str, float] = {}
    for s in sp:
        if s.depth == 1:
            out[s.name] = out.get(s.name, 0.0) + s.seconds
    return out

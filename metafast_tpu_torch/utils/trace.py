"""Spans and counters inside the launcher's steps, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session records: the
profiler is the one switch.  Off, ``span`` returns one shared no-op
context manager after a single flag test, and the counters return after
the same test.

On, a span
  - opens ``torch.profiler.record_function("mf." + name)``, so its range
    lies in the profiler's trace, on the clock of every kernel and memcpy;
  - logs ``[<name>] started`` and ``[<name>] done in <s>s`` through the
    launcher's logger, in the format of the steps' own lines
    (``tools/framework.py`` ``Tool.run``), so that a job's log nests the
    spans below its steps.  Seconds are ``time.perf_counter()``'s.

A span around device work that is only enqueued measures the enqueue.
Counters add to a dict of this module: ``d2h_bytes`` and ``h2d_bytes``
at the copies between host and device, ``written_bytes`` at the step-file
writers (the files a write span names).  Nothing here synchronises or
copies.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

_enabled = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()
_counts: dict[str, int] = {}


def _logger() -> logging.Logger:
    from ..tools.framework import LOGGER

    return logging.getLogger(LOGGER)


class _Span:
    __slots__ = ("name", "written", "_range", "_t0")

    def __init__(self, name: str, written):
        self.name, self.written = name, written

    def __enter__(self):
        self._range = torch.profiler.record_function("mf." + self.name)
        self._range.__enter__()
        _logger().info("[%s] started", self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, kind, value, tb):
        seconds = time.perf_counter() - self._t0
        if kind is None:     # a span that raised never finished, as a step
            _logger().info("[%s] done in %.6fs", self.name, seconds)
            for path in self.written:
                count("written_bytes", os.path.getsize(path))
        self._range.__exit__(kind, value, tb)


def span(name: str, *written):
    """A span named ``name``; ``written``: the files written inside it,
    whose sizes ``written_bytes`` adds when it ends."""
    if not _enabled():
        return _OFF
    return _Span(name, written)


def step(name: str):
    """The profiler's range ``mf.step.<name>`` around one launcher step
    (its log lines are ``Tool.run``'s own)."""
    if not _enabled():
        return _OFF
    return torch.profiler.record_function("mf.step." + name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name``."""
    if _enabled():
        _counts[name] = _counts.get(name, 0) + int(n)


def d2h(*tensors: torch.Tensor) -> None:
    """Count the bytes of tensors about to be copied to the host (a tensor
    on the host already moves nothing)."""
    if _enabled():
        count("d2h_bytes", sum(t.nbytes for t in tensors
                               if t.device.type != "cpu"))


def h2d(device: torch.device, *arrays) -> None:
    """Count the bytes of host arrays (or tensors) about to be copied to
    ``device`` (nothing moves to the CPU)."""
    if _enabled() and torch.device(device).type != "cpu":
        count("h2d_bytes", sum(a.nbytes for a in arrays))


def counters() -> dict[str, int]:
    """A copy of the counters, summed since the process began or
    ``reset``."""
    return dict(_counts)


def reset() -> None:
    """Set every counter back to nothing."""
    _counts.clear()

"""Span metrics that fall silent on a program without the span.

``spans.span_mean`` reads 0.0 where a traced run recorded other spans
but none of the name; a metric of a span that an older program lacks
reads nothing there instead.
"""

from __future__ import annotations

from .spans import span_mean


def named_span_mean(rec, name: str, step: str) -> float | None:
    """``span_mean(rec, name, step)``, or None where no completed job
    logged a span called ``name`` (or, where it ends in ``.``, one whose
    name starts with it)."""
    prefix = name.endswith(".")
    if not any((s.name.startswith(name) if prefix else s.name == name)
               for j in rec.jobs if j.rc == 0 for s in j.spans):
        return None
    return span_mean(rec, name, step)

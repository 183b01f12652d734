"""Over a run's jobs: the worst reading of each compared number, and
whether every one keeps its limit (the tool's ``LIMITS``)."""

from __future__ import annotations


def worst(readings: list[dict[str, float]], limits: dict
          ) -> dict[str, float | None]:
    """The largest reading of each number over jobs (None with no job
    to read)."""
    return {k: max((r[k] for r in readings), default=None) for k in limits}


def passed(numbers: dict[str, float | None], limits: dict) -> bool:
    return all(numbers[k] is not None and numbers[k] <= lim
               for k, lim in limits.items())

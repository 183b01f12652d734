"""Lookups in a sorted int64 key table.

Counterpart of metafast_tpu/graph/lookup.py ``find`` (:194-215).  The JAX
package joins by sorting because gathers were the TPU's weakest
primitive; here it is a binary search (``torch.searchsorted``).
"""

from __future__ import annotations

import torch

from ..core.bitpack import SENTINEL


def find(table: torch.Tensor, queries: torch.Tensor):
    """(index, found) per query in a sorted unique int64 table.

    The index is clipped into range and arbitrary where found is False;
    SENTINEL queries are never found.
    """
    n = table.numel()
    if n == 0:
        zero = torch.zeros_like(queries)
        return zero, torch.zeros_like(queries, dtype=torch.bool)
    idx = torch.searchsorted(table, queries).clamp_(max=n - 1)
    found = (table[idx] == queries) & (queries != SENTINEL)
    return idx, found


def values_at(table: torch.Tensor, values: torch.Tensor,
              queries: torch.Tensor) -> torch.Tensor:
    """values[i] where table[i] == query, else 0, per query (the first
    match where the sorted table repeats a key)."""
    if table.numel() == 0:
        return torch.zeros_like(queries, dtype=values.dtype)
    idx, found = find(table, queries)
    return torch.where(found, values[idx], 0)

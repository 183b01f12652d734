"""32-bit multiplicative hashing on int64 tensors.

The JAX package hashes uint32 values with wrapping uint32 multiplies
(vertex and shard hashes, the walk-start sample of graph/rank.py).  Torch
has no uint32 arithmetic on every device, so the port computes the same
bits in int64: values stay in [0, 2^32) and each product is split so that
it never overflows.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32), without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32

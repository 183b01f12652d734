"""Carrying data and state between the JAX package and the port.

The system has no weights; what the two packages share is counted k-mer
tables and component lists.  The JAX package keys k-mers as (hi, lo)
uint32 pairs with an all-ones sentinel pair; the port keys them as int64
with INT64_MAX as the sentinel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .core.bitpack import SENTINEL
from .graph.components import members_to_host
from .utils.device import resolve_device


def join_pairs(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """uint32 (hi, lo) pairs -> int64 keys; the sentinel pair -> SENTINEL.

    The counterpart of metafast_tpu.api.join_keys, which would map the
    sentinel pair to -1 (sorting first instead of last).
    """
    hi = np.asarray(hi, dtype=np.uint32)
    lo = np.asarray(lo, dtype=np.uint32)
    keys = ((hi.astype(np.uint64) << np.uint64(32))
            | lo.astype(np.uint64)).astype(np.int64)
    sent = (hi == 0xFFFFFFFF) & (lo == 0xFFFFFFFF)
    return np.where(sent, np.int64(SENTINEL), keys)


def table_from_jax(keys: np.ndarray, counts: np.ndarray,
                   device: str | torch.device):
    """A counted host table (int64 keys ascending, counts) -> device
    tensors (int64 keys, int32 counts)."""
    dev = resolve_device(device)
    return (torch.as_tensor(np.asarray(keys, dtype=np.int64)).to(dev),
            torch.as_tensor(np.asarray(counts, dtype=np.int32)).to(dev))


@dataclass
class HostComponent:
    """A component in the JAX package's shape (graph.components.Component)."""
    kmers: np.ndarray          # sorted int64 canonical keys
    weight: int
    used_freq_threshold: int

    @property
    def size(self) -> int:
        return len(self.kmers)


def components_to_numpy(components) -> list[HostComponent]:
    """The port's components (device kmer tensors) as host components."""
    return [HostComponent(kmers=km, weight=int(c.weight),
                          used_freq_threshold=int(c.used_freq_threshold))
            for km, c in zip(members_to_host(components), components)]

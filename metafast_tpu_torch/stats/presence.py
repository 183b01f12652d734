"""Per-sample presence/count structures over a unified sorted k-mer key axis.

The reference stores per-sample presence as striped bitset hash maps —
BigLong2BitShortaHashMap (src/structures/map/Long2BitShortaHashMap.java:13-120,
BITS_PER_WORD=4) filled by loadBitShortaKmers (src/io/IOUtils.java:507-539):
~1 bit per (key, sample) cell plus the 8-byte key, streaming ONE sample file
at a time.  The layout here is sort-based instead of hashed, with the same
streaming shape, on the run's device:

  * one sorted int64 key tensor [N] (the union of all samples' k-mers);
  * per-group presence counts [N], summed sample by sample: no [N, S]
    presence matrix is built;
  * every builder is SAMPLE-MAJOR: it iterates the sample tables once,
    holding a single sample's (keys, counts) at a time — a ``LazyTables``
    reads each file on demand, so the peak is O(N) + one sample, never
    O(N * S);
  * count matrices are only ever densified for SELECTED row subsets (the
    chi-squared survivors), matching how the reference's stats tools
    touch frequency values (StatsKmersFinder.java:222-247).

Counterpart of metafast_tpu/stats/presence.py, whose builders are host
NumPy; these give the same results as tensors on the tables' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import binfmt
from ..utils import trace


class LazyTables:
    """Sequence of per-sample (sorted keys, counts) tables, loaded from
    .kmers.bin files on demand — nothing is cached, so iterating costs one
    file read per sample and O(one sample) memory.  Each table is a pair
    of int64 tensors on ``device``, sorted there; the sort is stable, so
    a key a file repeats keeps its records in file order.

    Parity: the reference's stats tools stream each sample file once into
    the shared bitset map (src/io/IOUtils.java:507-539) instead of holding
    all samples resident.
    """

    def __init__(self, files, threshold: int, device):
        self.files = [str(f) for f in files]
        self.threshold = threshold
        self.device = device

    def __len__(self) -> int:
        return len(self.files)

    def __iter__(self):
        for f in self.files:
            yield self._load(f)

    def _load(self, path: str):
        """(int64 keys ascending, int64 counts) of one file, count >
        threshold kept (Kmers2HMWorker: value > freqThreshold)."""
        with trace.span("read.kmers_bin"):
            keys, counts = binfmt.read_kmers_bin(path)
        keep = counts > self.threshold
        keys, counts = keys[keep], counts[keep]
        trace.h2d(self.device, keys, counts)
        keys, order = torch.sort(torch.from_numpy(keys).to(self.device),
                                 stable=True)
        return keys, torch.from_numpy(counts).to(self.device)[order].long()


def sample_totals(tables) -> np.ndarray:
    """float64 [S]: per-sample sum of counts (depth normalizer,
    StatsKmersFinder.java:225-233)."""
    return np.array([float(sc.sum()) for _sk, sc in tables],
                    dtype=np.float64)


# sample keys buffered per union merge: each merge sorts acc+batch, so
# a smaller batch trades merge count for peak memory (~16x this in bytes
# of transient sort buffers at the default)
_UNION_BATCH = 1 << 27


def union_keys(tables) -> torch.Tensor:
    """Sorted union of the sample key arrays — one streaming pass.

    Samples accumulate into bounded batches before each unique-merge:
    a merge per sample would re-sort the whole accumulator once PER
    SAMPLE (50 full sorts at CAMI scale); batching cuts that to
    total_keys / _UNION_BATCH merges while keeping peak memory at
    ~(union + batch) x 2."""
    acc = torch.empty(0, dtype=torch.int64, device=tables.device)
    batch: list[torch.Tensor] = []
    batch_n = 0
    for sk, _sc in tables:
        batch.append(sk)
        batch_n += len(sk)
        if batch_n >= _UNION_BATCH:
            acc = torch.unique(torch.cat([acc] + batch))
            batch, batch_n = [], 0
    if batch:
        acc = torch.unique(torch.cat([acc] + batch))
    return acc


def group_presence_counts(tables, keys: torch.Tensor,
                          group_sizes: list[int]) -> list[torch.Tensor]:
    """Per group, int64 [N]: the number of its samples holding each key
    of the sorted ``keys`` — one streaming sample-major pass."""
    bounds = np.cumsum([0] + list(group_sizes))
    out = [torch.zeros(len(keys), dtype=torch.int64, device=keys.device)
           for _ in group_sizes]
    gi = 0
    for j, (sk, _sc) in enumerate(tables):
        while j >= bounds[gi + 1]:
            gi += 1
        # a row a sample hits twice (a repeated key) is counted once
        out[gi][torch.searchsorted(keys, sk)] += 1
    return out


def first_present_value(tables, keys: torch.Tensor) -> torch.Tensor:
    """int64 [N]: each key's count in the FIRST sample (by table order)
    containing it, 0 if absent everywhere.  Where that sample repeats the
    key, the count is the last of its run (the JAX package's fancy
    assignment lets the last write win), found by a right searchsorted,
    so no row is written twice.

    Parity: the scarce test of SpecificKmersFinder.java:155-158 reads the
    value at the first set sample; one streaming pass, no [N, S]."""
    out = torch.zeros(len(keys), dtype=torch.int64, device=keys.device)
    found = torch.zeros(len(keys), dtype=torch.bool, device=keys.device)
    for sk, sc in tables:
        if len(sk):
            idx = torch.searchsorted(sk, keys, right=True).sub_(1)
            idx.clamp_(min=0)
            hit = (sk[idx] == keys) & ~found
            out = torch.where(hit, sc[idx], out)
            found |= hit
    return out


def count_matrix(tables, keys: torch.Tensor) -> torch.Tensor:
    """int64 [N, S]: each key's count in each sample (0 when absent).

    Only call with a SELECTED key subset (chi-squared survivors etc.) —
    the full union at CAMI scale must never be densified.  ``keys`` need
    not be sorted; lookups run per sorted sample table."""
    cnt = torch.zeros((len(keys), len(tables)), dtype=torch.int64,
                      device=keys.device)
    for j, (sk, sc) in enumerate(tables):
        if len(sk):
            idx = torch.searchsorted(sk, keys).clamp_(max=len(sk) - 1)
            cnt[:, j] = torch.where(sk[idx] == keys, sc[idx], 0)
    return cnt

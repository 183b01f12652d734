"""Multi-device k-mer counting: hash-shard the key space, exchange exactly.

Counterpart of metafast_tpu/parallel/count.py.  Reads are data parallel
over the ranks; every rank extracts and counts its own share, and counted
tables move to the rank that owns each key (``hash_shard``, the JAX
package's mixing function, so rank s holds exactly the keys JAX device s
holds).  Identical keys always meet on one rank, so the per-rank tables
are complete and disjoint, and saturation commutes with the split:
min(sum_i min(c_i, S), S) == min(sum_i c_i, S).

Where it departs from the JAX package:
  - the exchange is one uneven ``all_to_all_single`` (per-peer counts
    first, then the payload), not fixed [n_shards, cap] buckets: nothing
    is padded and nothing is dropped, so ``sharded_count`` ignores
    ``cap_per_shard`` and always reports 0 dropped;
  - keys are int64 on the wire, not (hi, lo) uint32 pairs;
  - the counter has one extraction route, the compact 3-stream layout
    through the K1 kernel (the port's native library always loads or
    raises, so no rank can take the column layout).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.extract import extract_canonical
from ..ops.count import KmerCounter, count_keys, device_table, merge_counted
from ..utils.hash32 import M32, mul32
from . import distributed as D
from .distributed import Mesh, make_mesh  # noqa: F401  (JAX parity)


def hash_shard(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard id of each int64 key: metafast_tpu/parallel/count.py
    hash_shard (:53) on the key's uint32 halves, in int64 arithmetic."""
    hi, lo = keys >> 32, keys & M32
    h = mul32(hi, 0x85EBCA6B) ^ mul32(lo, 0xC2B2AE35)
    h ^= h >> 15
    h = mul32(h, 0x27D4EB2F)
    h ^= h >> 13
    return h % n_shards


def exchange_counted(mesh: Mesh, keys: torch.Tensor, counts: torch.Tensor):
    """A counted table's rows sent to the ranks that own their keys:
    (keys, int32 counts) received here, unsorted, keys may repeat."""
    (k, c), _ = D.exchange(mesh, hash_shard(keys, mesh.size), keys,
                           counts.to(torch.int64))
    return k, c.to(torch.int32)


def sharded_count(codes, lengths, *, k: int, mesh: Mesh,
                  cap_per_shard: int = 0):
    """Count the canonical k-mers of one global read batch over the mesh.

    Every rank passes the same global batch (codes [B, L] uint8, lengths
    [B], B divisible by the mesh size) and counts its row block.
    ``cap_per_shard`` is accepted for signature parity and ignored: the
    exchange is exact.  Returns this rank's shard table (int64 keys
    ascending, int32 counts, on the mesh's device), its unique count and
    the dropped count, which is always 0.
    """
    codes = torch.as_tensor(np.asarray(codes, dtype=np.uint8))
    lengths = torch.as_tensor(np.asarray(lengths, dtype=np.int32))
    B = codes.shape[0]
    if B % mesh.size:
        raise ValueError(f"batch of {B} reads is not divisible by the mesh "
                         f"size {mesh.size}")
    per = B // mesh.size
    rows = slice(mesh.rank * per, (mesh.rank + 1) * per)
    keys, _ = extract_canonical(codes[rows].to(mesh.device),
                                lengths[rows].to(mesh.device), k)
    keys, counts = count_keys(keys.reshape(-1))
    sent = keys.numel()
    keys, counts = exchange_counted(mesh, keys, counts)
    _check_exchange(mesh, sent, keys.numel())
    keys, counts = merge_counted(keys, counts)
    return keys, counts, keys.numel(), 0


def gather_counts(keys: torch.Tensor, counts: torch.Tensor,
                  mesh: Mesh) -> tuple[np.ndarray, np.ndarray]:
    """Every rank's disjoint shard table merged into one sorted (int64
    keys, int32 counts) on the host, on every rank."""
    return tuple(t.cpu().numpy() for t in _gather_table(mesh, keys, counts))


def _gather_table(mesh: Mesh, keys: torch.Tensor, counts: torch.Tensor):
    """The union of the ranks' disjoint tables, sorted, on every rank."""
    keys = D.all_gather_cat(mesh, keys)
    counts = D.all_gather_cat(mesh, counts.to(torch.int32))
    keys, order = torch.sort(keys)
    return keys, counts[order]


class ShardOverflowError(RuntimeError):
    """A shard exchange lost table entries.

    The exchange is exact, so this is unreachable; it survives as an
    invariant check (metafast_tpu/parallel/count.py :189)."""

    def __init__(self, dropped: int):
        super().__init__(
            f"shard exchange dropped {dropped} k-mer table entries "
            "(internal invariant violated)")
        self.dropped = dropped


def _check_exchange(mesh: Mesh, sent: int, received: int) -> None:
    """Raise ShardOverflowError on every rank unless the rows received
    over the group equal the rows sent (one all_reduce)."""
    lost = D.all_reduce(mesh, sent - received)
    if lost:
        raise ShardOverflowError(lost)


class ShardedKmerCounter:
    """Streaming canonical k-mer counter over the ranks of a mesh.

    The multi-device twin of ops.count.KmerCounter (same saturating
    semantics, same host spill).  Each rank extracts its own slabs with
    K1 and queues the raw keys; consolidation is a collective: every call
    to ``add_stream3`` / ``add_empty`` takes one all_reduce(MAX) of the
    ranks' pending key counts, and once it reaches ``chunk`` every rank
    counts its queue, sends the counted rows to their owners and merges
    what it receives into its shard table (which spills to host RAM at
    ``spill`` unique keys).  So every rank makes the same sequence of
    calls; a rank with nothing to add calls ``add_empty``.
    """

    def __init__(self, k: int, mesh: Mesh, chunk: int = 1 << 27,
                 spill: int | None = 1 << 27):
        if not 1 <= k <= 31:
            raise ValueError(f"k must be in [1, 31], got {k}")
        self.k = k
        self.mesh = mesh
        self._chunk = chunk
        self._pending: list[torch.Tensor] = []
        self._pending_n = 0
        self._shard = KmerCounter(k, mesh.device, chunk=chunk, spill=spill)
        self._total = None          # k-mers seen by every rank, at finish
        self.exchanges = 0

    @property
    def total_kmers_seen(self) -> int:
        """This rank's share until ``finish``, the sum over ranks after."""
        if self._total is None:
            return self._shard.total_kmers_seen
        return self._total

    def add_stream3(self, w0, w1, w2, vm, lengths) -> None:
        """Count one slab of this rank's reads in the compact 3-stream
        layout (ops.stream_extract.build_stream3, on the mesh's device)."""
        from ..ops.stream_extract import stream_extract

        self._shard._add_total(lengths)
        keys = stream_extract(w0, w1, w2, vm, self.k).reshape(-1)
        self._pending.append(keys)
        self._pending_n += keys.numel()
        self.add_empty()

    def add_empty(self) -> None:
        """This rank's turn of a lockstep call with nothing to add."""
        if D.all_reduce(self.mesh, self._pending_n, "max") >= self._chunk:
            self._consolidate()

    def _consolidate(self) -> None:
        """Count the queue, exchange, merge: a collective of every rank."""
        dev = self.mesh.device
        if self._pending:
            keys, counts = count_keys(torch.cat(self._pending))
        else:
            keys = torch.empty(0, dtype=torch.int64, device=dev)
            counts = torch.empty(0, dtype=torch.int32, device=dev)
        self._pending, self._pending_n = [], 0
        sent = keys.numel()
        keys, counts = exchange_counted(self.mesh, keys, counts)
        _check_exchange(self.mesh, sent, keys.numel())
        self.exchanges += 1
        if keys.numel():
            self._shard.add_counted(keys, counts)

    def finish_device(self):
        """(int64 keys ascending, int32 counts) of every rank's shard, on
        the mesh's device, the same on every rank; total_kmers_seen
        becomes the sum over ranks.  A collective."""
        if D.all_reduce(self.mesh, self._pending_n, "max"):
            self._consolidate()
        self._total = D.all_reduce(self.mesh, self._shard.total_kmers_seen)
        return _gather_table(self.mesh, *device_table(self._shard))

    def finish(self):
        """finish_device as numpy."""
        return tuple(t.cpu().numpy() for t in self.finish_device())

    @property
    def spill_events(self) -> int:
        return self._shard.spill_events

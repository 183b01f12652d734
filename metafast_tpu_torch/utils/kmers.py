"""Host-side k-mer helpers (string conversion, per-sequence extraction).

Nucleotide coding A=0, G=1, C=2, T=3 (itmo DnaTools.java:31-64).

The port's copy of metafast_tpu/utils/kmers.py.  Its ``kmer_string`` and
``rc64`` give the same results as the oracle's (metafast_tpu/oracle/
reference.py:36-46), which graph/contigs.py took before the port kept
its own copies.
"""

from __future__ import annotations

import numpy as np

_CHARS = np.frombuffer(b"AGCT", dtype=np.uint8)
_LUT = np.full(256, 255, dtype=np.uint8)
for _c, _v in (("A", 0), ("G", 1), ("C", 2), ("T", 3)):
    _LUT[ord(_c)] = _v
    _LUT[ord(_c.lower())] = _v


def kmer_string(key: int, k: int) -> str:
    """int64 canonical key -> nucleotide string (ShortKmer.toString)."""
    return "".join("AGCT"[(int(key) >> (2 * (k - 1 - t))) & 3]
                   for t in range(k))


def kmers_strings(keys: np.ndarray, k: int) -> list[str]:
    """Vectorized batch of kmer_string."""
    keys = np.asarray(keys, dtype=np.uint64)
    n = len(keys)
    if n == 0:
        return []
    chars = np.empty((n, k), dtype=np.uint8)
    for t in range(k):
        codes = (keys >> np.uint64(2 * (k - 1 - t))) & np.uint64(3)
        chars[:, t] = _CHARS[codes.astype(np.int64)]
    return [row.tobytes().decode() for row in chars]


def encode_seq(s: str) -> np.ndarray | None:
    """2-bit codes of a sequence, or None if it has invalid characters."""
    codes = _LUT[np.frombuffer(s.encode(), dtype=np.uint8)]
    if (codes == 255).any():
        return None
    return codes


def rc64(key: int, k: int) -> int:
    """Reverse complement of a 2k-bit key (KmerUtils.java:12-22)."""
    v = 0
    x = int(key)
    for _ in range(k):
        v = (v << 2) | (3 - (x & 3))
        x >>= 2
    return v


def sequence_kmers(s: str, k: int) -> np.ndarray:
    """All canonical k-mer keys of one sequence (with duplicates), int64.

    Vectorized sliding-window evaluation (same math as
    core/extract.extract_canonical, but host-side numpy for tool code).
    """
    codes = encode_seq(s)
    if codes is None or len(codes) < k:
        return np.empty(0, dtype=np.int64)
    P = len(codes) - k + 1
    c = codes.astype(np.uint64)
    fw = np.zeros(P, dtype=np.uint64)
    rc = np.zeros(P, dtype=np.uint64)
    for t in range(k):
        ct = c[t:t + P]
        fw |= ct << np.uint64(2 * (k - 1 - t))
        rc |= (np.uint64(3) - ct) << np.uint64(2 * t)
    return np.minimum(fw, rc).astype(np.int64)

"""Binary on-disk formats, bit-compatible with the reference toolkit.

All integers are big-endian (Java DataOutputStream).

  *.kmers.bin     repeated {int64 canonical k-mer, int16 count}, 10 B/record,
                  only entries with count > threshold
                  (src/io/IOUtils.java:45-71, src/io/KmersLoadWorker.java:9)
  colored kmers   repeated {int64 k-mer, int64 packed 3x20-bit class counts}
                  (src/io/IOUtils.java:73-99, src/algo/ColoredKmerOperations.java)
  components.bin  int32 n; per component: int32 size, int64 weight,
                  size x int64 k-mers (src/structures/ConnectedComponent.java:80-118)

Record order inside *.kmers.bin is hash-layout-dependent in the reference
(non-canonical); we write keys in ascending order.  All readers are
order-insensitive, so this is parity-safe and makes outputs reproducible.
"""

from __future__ import annotations

import numpy as np


def write_kmers_bin(path: str, keys: np.ndarray, counts: np.ndarray,
                    threshold: int | None = None) -> int:
    """Write {int64 key, int16 count} records; keep count > threshold if given.

    Returns the number of records written ("good" k-mers).
    """
    keys = np.asarray(keys, dtype=np.int64)
    counts = np.asarray(counts)
    if threshold is not None:
        keep = counts > threshold
        keys, counts = keys[keep], counts[keep]
    rec = np.zeros(len(keys), dtype=np.dtype([("key", ">i8"), ("cnt", ">i2")]))
    rec["key"] = keys
    rec["cnt"] = counts.astype(np.int16)
    with open(path, "wb") as fh:
        rec.tofile(fh)
    return len(keys)


def read_kmers_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read {int64 key, int16 count} records -> (keys int64, counts int32)."""
    rec = np.fromfile(path, dtype=np.dtype([("key", ">i8"), ("cnt", ">i2")]))
    return rec["key"].astype(np.int64), rec["cnt"].astype(np.int32)


def write_long_kmers_bin(path: str, keys: np.ndarray, values: np.ndarray,
                         threshold: int | None = None) -> int:
    """Write {int64 key, int64 value} records (colored k-mers)."""
    keys = np.asarray(keys, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    if threshold is not None:
        keep = values > threshold
        keys, values = keys[keep], values[keep]
    rec = np.zeros(len(keys), dtype=np.dtype([("key", ">i8"), ("val", ">i8")]))
    rec["key"] = keys
    rec["val"] = values
    with open(path, "wb") as fh:
        rec.tofile(fh)
    return len(keys)


def read_long_kmers_bin(path: str) -> tuple[np.ndarray, np.ndarray]:
    rec = np.fromfile(path, dtype=np.dtype([("key", ">i8"), ("val", ">i8")]))
    return rec["key"].astype(np.int64), rec["val"].astype(np.int64)


def write_components_bin(path: str, components) -> None:
    """components: iterable of (kmer_array int64, weight int)."""
    comps = list(components)
    with open(path, "wb") as fh:
        fh.write(np.array(len(comps), dtype=">i4").tobytes())
        for kmers, weight in comps:
            kmers = np.asarray(kmers, dtype=np.int64)
            fh.write(np.array(len(kmers), dtype=">i4").tobytes())
            fh.write(np.array(weight, dtype=">i8").tobytes())
            fh.write(kmers.astype(">i8").tobytes())


def read_components_bin(path: str) -> list[tuple[np.ndarray, int]]:
    """Returns list of (kmers int64 array, weight)."""
    out = []
    with open(path, "rb") as fh:
        raw = fh.read()
    off = 0
    n = int(np.frombuffer(raw, dtype=">i4", count=1, offset=off)[0]); off += 4
    for _ in range(n):
        size = int(np.frombuffer(raw, dtype=">i4", count=1, offset=off)[0]); off += 4
        weight = int(np.frombuffer(raw, dtype=">i8", count=1, offset=off)[0]); off += 8
        kmers = np.frombuffer(raw, dtype=">i8", count=size, offset=off).astype(np.int64)
        off += 8 * size
        out.append((kmers, weight))
    return out

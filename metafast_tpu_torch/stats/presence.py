"""Per-sample presence/count structures over a unified sorted k-mer key axis.

The reference stores per-sample presence as striped bitset hash maps —
BigLong2BitShortaHashMap (src/structures/map/Long2BitShortaHashMap.java:13-120,
BITS_PER_WORD=4) filled by loadBitShortaKmers (src/io/IOUtils.java:507-539):
~1 bit per (key, sample) cell plus the 8-byte key, streaming ONE sample file
at a time.  The TPU-native layout is sort-based instead of hashed, but
matches that density and streaming shape:

  * one sorted int64 key array [N] (the union of all samples' k-mers);
  * presence as a bit-packed [N, ceil(S/32)] uint32 matrix
    (``PackedPresence`` — 1 bit per sample, popcount cardinalities);
  * every builder is SAMPLE-MAJOR: it iterates the sample tables once,
    holding a single sample's (keys, counts) in memory at a time — pass a
    ``LazyTables`` and peak RSS is O(N) + one sample, never O(N * S);
  * count matrices are only ever densified for SELECTED row subsets (the
    chi-squared survivors), matching how the reference's stats tools
    touch frequency values (StatsKmersFinder.java:222-247).
"""

from __future__ import annotations

import numpy as np

from ..io import binfmt

# popcount over uint8 (numpy has no vectorized popcount); one 256-entry
# LUT indexed by byte view
_POPCNT8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def _popcount_u32(words: np.ndarray) -> np.ndarray:
    """Per-element popcount of a uint32 array (any shape)."""
    b = np.ascontiguousarray(words).view(np.uint8)
    return _POPCNT8[b].reshape(*words.shape, 4).sum(axis=-1, dtype=np.int64)


class LazyTables:
    """Sequence of per-sample (sorted keys, counts) tables, loaded from
    .kmers.bin files on demand — nothing is cached, so iterating costs one
    file read per sample and O(one sample) memory.

    Parity: the reference's stats tools stream each sample file once into
    the shared bitset map (src/io/IOUtils.java:507-539) instead of holding
    all samples resident.
    """

    def __init__(self, files, threshold: int = 0):
        self.files = [str(f) for f in files]
        self.threshold = threshold

    def __len__(self) -> int:
        return len(self.files)

    def __add__(self, other: "LazyTables") -> "LazyTables":
        assert self.threshold == other.threshold
        return LazyTables(self.files + other.files, self.threshold)

    def __getitem__(self, i):
        if isinstance(i, slice):
            sub = LazyTables(self.files[i], self.threshold)
            return sub
        return _load_one(self.files[i], self.threshold)

    def __iter__(self):
        for f in self.files:
            yield _load_one(f, self.threshold)


def _load_one(path: str, threshold: int):
    keys, counts = binfmt.read_kmers_bin(path)
    keep = counts > threshold
    keys, counts = keys[keep], counts[keep]
    order = np.argsort(keys)
    return keys[order], counts[order].astype(np.int64)


def load_sample_tables(files, threshold: int = 0):
    """Eager [(keys_sorted, counts)] per file (count > threshold kept).

    Parity: per-record filter in Kmers2HMWorker (value > freqThreshold).
    Prefer LazyTables for large multi-sample runs."""
    return [_load_one(str(f), threshold) for f in files]


def sample_totals(tables) -> np.ndarray:
    """float64 [S]: per-sample sum of counts (depth normalizer,
    StatsKmersFinder.java:225-233)."""
    return np.array([float(sc.sum()) for _sk, sc in tables],
                    dtype=np.float64)


class PackedPresence:
    """Bit-packed keys x samples membership: [N, ceil(S/32)] uint32.

    The sort-native equivalent of the reference's Long2BitShortaHashMap
    (src/structures/map/Long2BitShortaHashMap.java:13-120): `set` =
    construction from per-sample sorted key arrays, `getCardinality(key,
    from, to)` = `cardinality(from, to)[row]`.  1 bit per (key, sample)
    cell; rows align with the sorted union key array.
    """

    __slots__ = ("words", "n_samples")

    def __init__(self, n_keys: int, n_samples: int):
        self.n_samples = n_samples
        self.words = np.zeros((n_keys, (n_samples + 31) // 32),
                              dtype=np.uint32)

    @classmethod
    def from_tables(cls, tables, keys: np.ndarray) -> "PackedPresence":
        """Build from per-sample sorted tables — one streaming pass,
        holding one sample in memory at a time (pass a LazyTables)."""
        S = len(tables)
        out = cls(len(keys), S)
        w = out.words
        for j, (sk, _sc) in enumerate(tables):
            rows = np.searchsorted(keys, sk)
            w[rows, j >> 5] |= np.uint32(1 << (j & 31))
        return out

    def column_mask(self, lo: int, hi: int) -> np.ndarray:
        """[W] uint32 mask selecting sample columns in [lo, hi)."""
        W = self.words.shape[1]
        mask = np.zeros(W, dtype=np.uint32)
        for j in range(lo, hi):
            mask[j >> 5] |= np.uint32(1 << (j & 31))
        return mask

    def cardinality(self, lo: int = 0, hi: int | None = None) -> np.ndarray:
        """[N] int64: per key, number of samples in [lo, hi) containing it.

        Parity: Long2BitShortaHashMap.getCardinality(key, from, to)
        (src/structures/map/Long2BitShortaHashMap.java:73-96), vectorized
        over every key at once."""
        if hi is None:
            hi = self.n_samples
        mask = self.column_mask(lo, hi)
        return _popcount_u32(self.words & mask[None, :]).sum(axis=1)

    def contains(self, row: int, sample: int) -> bool:
        return bool((self.words[row, sample >> 5]
                     >> np.uint32(sample & 31)) & np.uint32(1))

    @property
    def nbytes(self) -> int:
        return self.words.nbytes


# sample keys buffered per union merge: each merge sorts acc+batch, so
# a smaller batch trades merge count for peak memory (~16x this in bytes
# of transient sort buffers at the default)
_UNION_BATCH = 1 << 27


def union_keys(tables) -> np.ndarray:
    """Sorted union of the sample key arrays — one streaming pass.

    Samples accumulate into bounded batches before each unique-merge:
    per-sample np.union1d would re-sort the whole accumulator once PER
    SAMPLE (50 full sorts at CAMI scale); batching cuts that to
    total_keys / _UNION_BATCH merges while keeping peak memory at
    ~(union + batch) x 2."""
    acc = np.empty(0, dtype=np.int64)
    batch: list[np.ndarray] = []
    batch_n = 0
    for sk, _sc in tables:
        batch.append(sk)
        batch_n += len(sk)
        if batch_n >= _UNION_BATCH:
            acc = np.unique(np.concatenate([acc] + batch))
            batch, batch_n = [], 0
    if batch:
        acc = np.unique(np.concatenate([acc] + batch))
    return acc


def group_presence_counts(tables, keys: np.ndarray,
                          group_sizes: list[int]) -> list[np.ndarray]:
    """Per-group [N] presence counts without materializing any [N, S].

    Equivalent to summing presence_matrix columns per group; one
    streaming sample-major pass."""
    N = len(keys)
    bounds = np.cumsum([0] + list(group_sizes))
    out = [np.zeros(N, dtype=np.int64) for _ in group_sizes]
    gi = 0
    for j, (sk, _sc) in enumerate(tables):
        while j >= bounds[gi + 1]:
            gi += 1
        out[gi][np.searchsorted(keys, sk)] += 1
    return out


def first_present_value(tables, keys: np.ndarray) -> np.ndarray:
    """[N] int64: each key's count in the FIRST sample (by table order)
    containing it, 0 if absent everywhere.

    Parity: the scarce test of SpecificKmersFinder.java:155-158 reads the
    value at the first set sample; one streaming pass, no [N, S]."""
    N = len(keys)
    out = np.zeros(N, dtype=np.int64)
    found = np.zeros(N, dtype=bool)
    for sk, sc in tables:
        rows = np.searchsorted(keys, sk)
        fresh = ~found[rows]
        out[rows[fresh]] = sc[fresh]
        found[rows[fresh]] = True
    return out


def presence_matrix(tables, keys: np.ndarray) -> np.ndarray:
    """bool [N, S]: keys x samples membership.

    DENSE — kept for small inputs and tests; production stats paths use
    PackedPresence / group_presence_counts (8-72x less memory)."""
    N, S = len(keys), len(tables)
    pres = np.zeros((N, S), dtype=bool)
    for j, (sk, _sc) in enumerate(tables):
        idx = np.searchsorted(keys, sk)
        pres[idx, j] = True
    return pres


def count_matrix(tables, keys: np.ndarray,
                 dtype=np.int64) -> np.ndarray:
    """[N, S] per-sample count of each key (0 when absent).

    Only call with a SELECTED key subset (chi-squared survivors etc.) —
    the full union at CAMI scale must never be densified.  `keys` need
    not be sorted; lookups run per sorted sample table."""
    N, S = len(keys), len(tables)
    cnt = np.zeros((N, S), dtype=dtype)
    for j, (sk, sc) in enumerate(tables):
        idx = np.searchsorted(sk, keys)
        idx_c = np.clip(idx, 0, max(len(sk) - 1, 0))
        if len(sk):
            hit = sk[idx_c] == keys
            cnt[hit, j] = sc[idx_c[hit]]
    return cnt

"""The port's pivot and colored extraction against the JAX package's.

Seeded multi-genome k-mer tables (as tests/test_pivot.py builds them)
with a random subset of pivots go through split_around_pivot of both
packages: depth 1 through the native traversal (the port's index tables
built on the device, the JAX package's in the native hash), depths 2 and
3 through the Python spec over the port's device-built index tables (on
the CPU here).  Every component must be equal field by field, in list
order.
"""

import logging

import numpy as np
import pytest
import torch

from metafast_tpu.graph import colored as jax_col
from metafast_tpu.graph import pivot as jax_pivot
from metafast_tpu.oracle import reference as oracle
from metafast_tpu_torch.graph import colored as col
from metafast_tpu_torch.graph import pivot
from metafast_tpu_torch.utils.kmers import sequence_kmers
from metafast_tpu_torch.utils.native import native_library
from torch_helpers import jax_neighbor_index

K = 13


def _table(seed: int, n_genomes: int = 3):
    """Counted canonical keys of reads of random genomes (sorted int64
    keys, int64 counts) and a random pivot subset."""
    rng = np.random.default_rng(seed)
    table = {}
    for _ in range(n_genomes):
        glen = int(rng.integers(300, 2000))
        genome = "".join("ACGT"[i] for i in rng.integers(0, 4, glen))
        reads = [genome[s:s + 60]
                 for s in rng.integers(0, max(glen - 60, 1), 400)]
        for key, c in oracle.count_reads(reads, K).items():
            table[key] = table.get(key, 0) + c
    keys = np.array(sorted(table), dtype=np.int64)
    counts = np.array([table[int(x)] for x in keys], dtype=np.int64)
    n_piv = int(rng.integers(1, max(len(keys) // 8, 2)))
    pivots = np.sort(rng.choice(keys, n_piv, replace=False))
    return keys, counts, pivots


def _assert_same_components(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g.kmers, w.kmers)
        assert (g.weight, g.n_pivot, g.used_freq_threshold) == (
            w.weight, w.n_pivot, w.used_freq_threshold)


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_graph_index_matches_jax(seed):
    """The port's _Graph tables (device searchsorted, on the CPU) equal
    the JAX package's host index, and its native hash index."""
    keys, counts, _ = _table(seed)
    want = jax_pivot._Graph(keys, counts, K)
    got = pivot._Graph(keys, counts, K, "cpu")
    assert got.right == want.right and got.left == want.left
    assert got.counts_l == want.counts_l
    left, right = jax_neighbor_index(keys, K)
    assert got.right == right.tolist() and got.left == left.tolist()
    assert sum(j >= 0 for row in got.right for j in row) > len(keys) // 2


def _index_table(kind: str, k: int):
    """A sorted int64 key table of one ``kind``: "random" canonical keys
    (few neighbours), "chain" (the keys of three genomes sharing a
    region), or "repeated" (the chain table with some keys repeated, as
    one .kmers.bin is sorted but not deduplicated)."""
    rng = np.random.default_rng(k)
    if kind == "random":
        keys = rng.integers(0, 1 << (2 * k), 4_000, dtype=np.int64)
        return np.unique(pivot.canonical_np(keys, k))
    shared = "".join(rng.choice(list("ACGT"), 600))
    keys = np.unique(np.concatenate([
        sequence_kmers("".join(rng.choice(list("ACGT"), 900)) + shared
                       + "".join(rng.choice(list("ACGT"), 900)), k)
        for _ in range(3)]))
    if kind == "chain":
        return keys
    return np.sort(np.repeat(keys, rng.integers(1, 4, len(keys))))


@pytest.mark.parametrize("kind", ["random", "chain", "repeated"])
@pytest.mark.parametrize("k", [23, 31])
def test_depth1_index_matches_native_hash(k, kind, monkeypatch):
    """The depth-1 route's int32 (left, right) tables, built in several
    row blocks, equal the JAX package's native hash's: a repeated key
    maps to the last index of its run."""
    keys = _index_table(kind, k)
    monkeypatch.setattr(pivot, "_INDEX_BLOCK", 1_000)
    assert len(keys) > 2 * pivot._INDEX_BLOCK
    left, right = pivot.depth1_index(torch.from_numpy(keys), k)
    want_left, want_right = jax_neighbor_index(keys, k)
    assert left.dtype == right.dtype == np.int32
    assert np.array_equal(left, want_left)
    assert np.array_equal(right, want_right)
    if kind != "random":
        assert (right >= 0).sum() > len(keys) // 2
    if kind == "repeated":
        first = pivot.neighbor_index(torch.from_numpy(keys), k)[0].numpy()
        assert not np.array_equal(first, right)


@pytest.mark.parametrize("k", [23, 31])
def test_split_around_pivot_repeated_keys_matches_jax(k):
    """At depth 1 on a table with repeated keys the port's components
    equal the JAX package's, whose index is the native hash."""
    keys = _index_table("repeated", k)
    rng = np.random.default_rng(k + 1)
    counts = rng.integers(1, 9, len(keys))
    pivots = np.sort(rng.choice(np.unique(keys), 40, replace=False))
    want = jax_pivot.split_around_pivot(keys, counts, k, pivots)
    got = pivot.split_around_pivot(keys, counts, k, pivots, device="cpu")
    _assert_same_components(got, want)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("seed", [21, 24])
def test_split_around_pivot_matches_jax(seed, depth):
    keys, counts, pivots = _table(seed)
    want = jax_pivot.split_around_pivot(keys, counts, K, pivots, depth)
    got = pivot.split_around_pivot(keys, counts, K, pivots, depth,
                                   device="cpu")
    _assert_same_components(got, want)


def test_native_overflow_takes_the_python_spec(monkeypatch, caplog):
    """A members overflow of the native depth-1 traversal (it returns -1)
    gives the Python spec's components, with a warning."""
    keys, counts, pivots = _table(25)
    want = jax_pivot.split_around_pivot(keys, counts, K, pivots)
    monkeypatch.setattr(native_library(), "pivot_bfs_depth1",
                        lambda *args: -1)
    with caplog.at_level(logging.WARNING, "metafast_torch.graph"):
        got = pivot.split_around_pivot(keys, counts, K, pivots, device="cpu")
    _assert_same_components(got, want)
    assert "members buffer overflow" in caplog.text


def test_neighbors_np_match_jax():
    rng = np.random.default_rng(3)
    for k in (5, 17, 31):
        keys = rng.integers(0, 1 << (2 * k), 200, dtype=np.int64)
        for name in ("rc_np", "canonical_np", "right_neighbors_np",
                     "left_neighbors_np"):
            assert np.array_equal(getattr(pivot, name)(keys, k),
                                  getattr(jax_pivot, name)(keys, k)), name


# ---------------------------------------------------------------------------
# colored k-mers
# ---------------------------------------------------------------------------

def test_color_values_at_the_saturation_edge():
    edge = np.array([0, 1, col.COLOR_MAX - 2, col.COLOR_MAX - 1,
                     col.COLOR_MAX], dtype=np.int64)
    rng = np.random.default_rng(6)
    for color in range(3):
        base = rng.integers(0, 1 << 60, len(edge), dtype=np.int64)
        base = col.add_value(base & ~(col.COLOR_MAX << (color * col.POWER)),
                             color, edge)
        for add in (0, 1, 2, [3, 2, 1, 1, 0]):
            got = col.add_value(base, color, add)
            want = jax_col.add_value(base, color, add)
            assert np.array_equal(got, want)
            assert np.array_equal(col.get_value(got, color),
                                  jax_col.get_value(want, color))
        assert col.get_value(col.add_value(base, color, 1),
                             color).max() == col.COLOR_MAX
        for perc in (0.5, 0.9, 1.0):
            assert np.array_equal(col.get_color(base, perc),
                                  jax_col.get_color(base, perc))


def _colored_table(seed: int):
    """Three genomes sharing a region, counted per class into packed
    colored values (as tests/test_pivot.py builds them)."""
    rng = np.random.default_rng(seed)
    table = {}
    share = "".join("ACGT"[i] for i in rng.integers(0, 4, 300))
    for g in range(3):
        genome = share + "".join(
            "ACGT"[i] for i in rng.integers(0, 4, int(rng.integers(400, 1200))))
        reads = [genome[s:s + 60]
                 for s in rng.integers(0, max(len(genome) - 60, 1), 350)]
        for key, c in oracle.count_reads(reads, K).items():
            v = table.get(key, 0)
            table[key] = jax_col.add_value(np.array([v]), g, min(c, 100))[0]
    keys = np.array(sorted(table), dtype=np.int64)
    values = np.array([table[int(x)] for x in keys], dtype=np.int64)
    order = np.random.default_rng(seed).permutation(len(keys))
    return keys[order], values[order]


MODES = {"default": {}, "separate": {"separate": True},
         "linear": {"linear": True}, "n_comps": {"n_comps": 3},
         "linear_n_comps": {"linear": True, "n_comps": 2, "perc": 0.6}}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", [17, 18])
def test_split_colored_matches_jax(seed, mode):
    keys, values = _colored_table(seed)
    want = jax_col.split_colored(keys, values, K, **MODES[mode])
    got = col.split_colored(keys, values, K, **MODES[mode], device="cpu")
    assert sorted(got) == sorted(want) == [0, 1, 2]
    assert sum(len(v) for v in got.values()) > 0
    for c in want:
        assert len(got[c]) == len(want[c])
        for g, w in zip(got[c], want[c]):
            assert np.array_equal(g.kmers, w.kmers)
            assert (g.weight, g.color) == (w.weight, w.color)


def test_colored_overflow_takes_the_python_spec(monkeypatch, caplog):
    keys, values = _colored_table(19)
    want = jax_col.split_colored(keys, values, K)
    monkeypatch.setattr(native_library(), "colored_bfs", lambda *args: -1)
    with caplog.at_level(logging.WARNING, "metafast_torch.graph"):
        got = col.split_colored(keys, values, K, device="cpu")
    assert "members buffer overflow" in caplog.text
    for c in want:
        assert [(g.kmers.tolist(), g.weight) for g in got[c]] == [
            (w.kmers.tolist(), w.weight) for w in want[c]]


"""The port's graph stages against the JAX package on one counted table.

A table is counted once (JAX counter, numpy inputs) and handed to both
packages: to the JAX functions as its (hi, lo) pairs / int64 host keys,
to the port through state.table_from_jax.  Neighbor tables must agree
field by field, contigs as lists and components field by field in order.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from metafast_tpu.graph import components as jcomp
from metafast_tpu.graph import contigs as jcontigs
from metafast_tpu.graph import dbg as jdbg
from metafast_tpu.ops.count import KmerCounter as JCounter
from metafast_tpu_torch.graph import components as tcomp
from metafast_tpu_torch.graph import contigs as tcontigs
from metafast_tpu_torch.graph import dbg as tdbg
from metafast_tpu_torch.state import (components_to_numpy, join_pairs,
                                      table_from_jax)

BASES = np.frombuffer(b"AGCT", dtype=np.uint8)   # code order A=0 G=1 C=2 T=3


def _table(k, seed, genome_len=6000, cov=10, read_len=90, palindromes=0,
           b=1):
    """Counted table of reads drawn from a random genome (codes), with
    read coverage varying along the genome so thresholds split it."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len).astype(np.uint8)
    # a repeat longer than k: forks at both of its ends
    genome[genome_len // 2:genome_len // 2 + 2 * k] = genome[50:50 + 2 * k]
    half = k // 2
    for p in range(palindromes):
        # an even-length reverse-complement palindrome (k even: a
        # palindromic k-mer sits at its centre)
        left = rng.integers(0, 4, half + 3).astype(np.uint8)
        pal = np.concatenate([left, (3 - left)[::-1]])
        pos = 200 + p * (genome_len - 400) // max(palindromes, 1)
        genome[pos:pos + len(pal)] = pal
    weights = 1.0 + 3.0 * (np.sin(np.arange(genome_len - read_len) / 400) > 0)
    n_reads = genome_len * cov // read_len
    starts = rng.choice(genome_len - read_len, n_reads,
                        p=weights / weights.sum())
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    lengths = np.full(n_reads, read_len, np.int32)
    c = JCounter(k)
    c.add_stream3(reads.ravel(), lengths)
    keys, counts = c.finish()
    keep = counts > b
    return keys[keep], counts[keep]


def _pairs(keys):
    u = keys.astype(np.uint64)
    return (jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


@pytest.mark.parametrize("k", [15, 16, 31])
def test_neighbor_tables_match_jax(k):
    keys, counts = _table(k, seed=k, palindromes=2 if k % 2 == 0 else 0)
    want = jdbg.neighbor_tables(*_pairs(keys), k)
    tkeys, _ = table_from_jax(keys, counts, "cpu")
    got = tdbg.neighbor_tables(tkeys, k)
    for side in ("left", "right"):
        w, g = want[side], got[side]
        present = np.asarray(w["present"])
        assert np.array_equal(g["present"].numpy(), present)
        assert np.array_equal(g["is_fw"].numpy(), np.asarray(w["is_fw"]))
        assert np.array_equal(g["ext"].numpy(), np.asarray(w["ext"]))
        assert np.array_equal(g["val"].numpy(),
                              join_pairs(w["val_hi"], w["val_lo"]))
        assert np.array_equal(g["idx"].numpy()[present],
                              np.asarray(w["idx"])[present])
    assert any((got[s]["ext"] == tdbg.FORK).any() for s in got)
    assert np.array_equal(
        tdbg.ext_map_rc(got["left"]["ext"]).numpy(),
        np.asarray(jdbg.ext_map_rc(want["left"]["ext"])))


@pytest.mark.parametrize("k,palindromes", [(31, 0), (16, 3), (12, 3)])
def test_build_contigs_match_jax(k, palindromes):
    keys, counts = _table(k, seed=100 + k, palindromes=palindromes)
    want = jcontigs.build_contigs(keys, counts, k, 2 * k)
    got = tcontigs.build_contigs(*table_from_jax(keys, counts, "cpu"), k,
                                 2 * k)
    assert len(want) > 3
    assert got == want
    if palindromes:
        pal = [key for key in keys.tolist()
               if _rc(key, k) == key]
        assert pal, "the table should hold palindromic k-mers"


def _rc(v, k):
    out = 0
    for _ in range(k):
        out = (out << 2) | (3 - (v & 3))
        v >>= 2
    return out


@pytest.mark.parametrize("k,b1,b2", [(31, 20, 400), (21, 5, 150),
                                     (16, 1, 60)])
def test_split_components_match_jax(k, b1, b2):
    keys, counts = _table(k, seed=200 + k, genome_len=8000, b=0)
    want = jcomp.split_components(keys, counts, k, b1, b2)
    got = components_to_numpy(tcomp.split_components(
        *table_from_jax(keys, counts, "cpu"), k, b1, b2))
    assert len(want) >= 3
    assert max(c.used_freq_threshold for c in want) >= 2
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g.kmers, w.kmers)
        assert (g.weight, g.used_freq_threshold) == (
            w.weight, w.used_freq_threshold)


def test_connected_labels_fixed_point():
    # a path 0-1-...-9 with random ids, a triangle, isolated vertices and
    # an inactive vertex splitting the path in two
    import torch

    rng = np.random.default_rng(1)
    M = 20
    perm = rng.permutation(M)
    edges = [(perm[i], perm[i + 1]) for i in range(9)] + [
        (perm[12], perm[13]), (perm[13], perm[14]), (perm[14], perm[12])]
    nbr = -np.ones((8, M), np.int64)
    fill = np.zeros(M, int)
    for a, b in edges:
        nbr[fill[a], a] = b
        fill[a] += 1
        nbr[fill[b], b] = a
        fill[b] += 1
    active = np.ones(M, bool)
    active[perm[4]] = False
    labels = tcomp.connected_labels(torch.from_numpy(nbr),
                                    torch.from_numpy(active)).numpy()
    want = np.asarray(jcomp._connected_labels_device(
        jnp.asarray(nbr.astype(np.int32)), jnp.asarray(active)))
    assert np.array_equal(labels, want)
    assert labels[perm[4]] == M
    assert len({labels[perm[i]] for i in range(4)}) == 1
    assert labels[perm[0]] != labels[perm[5]]

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
from metafast_tpu_torch.graph import components as tcomp
from metafast_tpu_torch.graph import contigs as tcontigs
from metafast_tpu_torch.graph import dbg as tdbg
from metafast_tpu_torch.state import (components_to_numpy, join_pairs,
                                      table_from_jax)
from torch_helpers import PATH_CASES, path_table
from torch_helpers import counted_table as _table

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


@pytest.mark.parametrize("case", sorted(PATH_CASES))
def test_split_components_cases_match_jax(case, monkeypatch):
    """The device grouping on tables of disjoint paths (torch_helpers.
    PATH_CASES): groups of exactly b1 and b2 keys, a component that
    climbs thresholds until it fits and one until it empties, ties that
    only the smallest member key orders, levels that compact and that do
    not; the components equal the JAX package's, field by field in
    order."""
    b1, b2, paths = PATH_CASES[case]
    keys, counts = path_table(paths, seed=len(case))
    tables = []
    neighbor_tables = tdbg.neighbor_tables

    def spy(keys, k):
        tables.append(keys.numel())
        return neighbor_tables(keys, k)

    monkeypatch.setattr(tdbg, "neighbor_tables", spy)
    got = components_to_numpy(tcomp.split_components(
        *table_from_jax(keys, counts, "cpu"), 31, b1, b2))
    want = jcomp.split_components(keys, counts, 31, b1, b2)
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert np.array_equal(g.kmers, w.kmers)
        assert (g.weight, g.used_freq_threshold) == (
            w.weight, w.used_freq_threshold)
    # one neighbour table a compaction: level 2 of the climb beside 40
    # paths keeps 220 of 1220 rows
    assert tables == ([1220, 220] if case == "climb_compacts"
                      else [len(keys)])
    order = [(c.used_freq_threshold, -c.weight, -c.size) for c in got]
    if case == "window_edges":
        assert {(b1, 1), (b2, 1), (b2, 2), (b1, 2)} <= {
            (c.size, c.used_freq_threshold) for c in got}
    elif case.startswith("climb"):
        assert max(c.used_freq_threshold for c in got) == 4
    else:
        assert len(set(order)) < len(order)
    assert order == sorted(order)


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

"""The port's three component labellers (graph/components.py: star
contraction, chain walks, hooking) against the JAX package's and each
other, and split_components on the walk and star route.

Every comparison is exact: labels are the min index per active vertex, M
on inactive rows, in both packages.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metafast_tpu.core import bitpack as jbp
from metafast_tpu.graph import components as jcomp
from metafast_tpu.oracle import reference as oracle
from metafast_tpu_torch.graph import components as tcomp
from metafast_tpu_torch.state import components_to_numpy, table_from_jax
from torch_helpers import counted_table

PORT = Path(tcomp.__file__).resolve().parents[1]


def _random_graph(seed, n_edges=None):
    """Symmetric [8, M] adjacency and active mask (the construction of
    tests/test_rank.py test_star_labels_match_hooking)."""
    rng = np.random.default_rng(seed)
    M = int(rng.integers(64, 2000))
    nbr = np.full((8, M), -1, dtype=np.int32)
    used = np.zeros((8, M), dtype=bool)
    if n_edges is None:
        n_edges = int(rng.integers(0, 3 * M))
    for _ in range(n_edges):
        u = rng.integers(0, M)
        v = rng.integers(0, M)
        if u == v:
            continue
        su = rng.integers(0, 8)
        sv = rng.integers(0, 8)
        if used[su, u] or used[sv, v]:
            continue
        nbr[su, u] = v
        nbr[sv, v] = u
        used[su, u] = used[sv, v] = True
    active = rng.random(M) < 0.6
    return nbr, active


@pytest.mark.parametrize("case", ["seed0", "seed3", "no_edges",
                                  "all_inactive"])
def test_star_labels_match_jax_and_hooking(case):
    seed = 3 if case == "seed3" else 0
    nbr, active = _random_graph(seed, 0 if case == "no_edges" else None)
    if case == "all_inactive":
        active[:] = False
    jn, ja = jnp.asarray(nbr), jnp.asarray(active)
    fused = np.asarray(jcomp._connected_labels_device(jn, ja))
    jstar = np.asarray(jcomp.star_connected_labels(jn, ja))
    tn = torch.from_numpy(nbr.astype(np.int64))
    ta = torch.from_numpy(active)
    star = tcomp.star_connected_labels(tn, ta).numpy()
    assert np.array_equal(star, fused)
    assert np.array_equal(star, jstar)
    assert np.array_equal(star, tcomp.hooking_connected_labels(tn, ta).numpy())
    assert np.array_equal(star, tcomp.connected_labels(tn, ta).numpy())
    M = nbr.shape[1]
    if case in ("no_edges", "all_inactive"):
        ids = np.where(active, np.arange(M), M)
        assert np.array_equal(star, ids)
    else:
        assert len(np.unique(star[active])) < active.sum()


def _circular_table():
    """The table of tests/test_rank.py test_walk_components_match_hooking_
    with_cycles: three circular genomes (pure cycle chains, no heads) and
    a linear one, k = 13."""
    rng = np.random.default_rng(11)
    bases = "ACGT"
    k = 13
    table = {}
    for _ in range(3):
        glen = int(rng.integers(300, 1200))
        genome = "".join(bases[i] for i in rng.integers(0, 4, glen))
        circ = genome + genome[:60]
        reads = [circ[s:s + 60] for s in range(0, glen, 7)]
        for key, c in oracle.count_reads(reads, k).items():
            table[key] = table.get(key, 0) + c
    genome = "".join(bases[i] for i in rng.integers(0, 4, 800))
    for key, c in oracle.count_reads(
            [genome[s:s + 60] for s in rng.integers(0, 740, 300)],
            k).items():
        table[key] = table.get(key, 0) + c
    return np.array(sorted(table), dtype=np.uint64), k


def _jax_walk_labels(keys, k):
    """JAX walk_connected_labels on (khi, klo) padded with SENTINEL,
    cut to the real rows."""
    M0 = len(keys)
    M = 1 << int(np.ceil(np.log2(max(M0, 16))))
    khi = np.full(M, jbp.SENTINEL, dtype=np.uint32)
    klo = np.full(M, jbp.SENTINEL, dtype=np.uint32)
    u = keys.astype(np.uint64)
    khi[:M0] = (u >> np.uint64(32)).astype(np.uint32)
    klo[:M0] = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.asarray(jcomp.walk_connected_labels(
        jnp.asarray(khi), jnp.asarray(klo), k))[:M0]


@pytest.mark.parametrize("table", ["circular", "k16_palindromes", "k31"])
def test_walk_labels_match_jax_and_hooking(table):
    if table == "circular":
        keys, k = _circular_table()
    else:
        k = 16 if table == "k16_palindromes" else 31
        keys, _ = counted_table(k, 400 + k, genome_len=4000, b=0,
                                palindromes=3 if k == 16 else 0)
    tkeys = torch.from_numpy(keys.astype(np.int64))
    walk = tcomp.walk_connected_labels(tkeys, k).numpy()
    assert np.array_equal(walk, _jax_walk_labels(keys, k))
    active = torch.ones(len(keys), dtype=torch.bool)
    hook = tcomp.hooking_connected_labels(tcomp.adjacency(tkeys, k), active)
    assert np.array_equal(walk, hook.numpy())
    assert np.array_equal(
        walk, tcomp.star_connected_labels(tcomp.adjacency(tkeys, k),
                                          active).numpy())


def test_walk_labels_sentinel_rows():
    """SENTINEL rows (as a padded table has) come out M and do not join
    any component."""
    keys, k = _circular_table()
    M0 = len(keys)
    padded = np.concatenate([keys.astype(np.int64),
                             np.full(5, (1 << 63) - 1, np.int64)])
    got = tcomp.walk_connected_labels(torch.from_numpy(padded), k).numpy()
    want = tcomp.walk_connected_labels(
        torch.from_numpy(keys.astype(np.int64)), k).numpy()
    assert np.array_equal(got[:M0], want)
    assert (got[M0:] == len(padded)).all()


@pytest.mark.parametrize("k,b1,b2", [(31, 20, 400), (21, 5, 150),
                                     (16, 1, 60)])
def test_split_components_walk_and_star_route_match_jax(k, b1, b2,
                                                        monkeypatch):
    """With the walk threshold patched down, full-live levels take
    walk_connected_labels and the others star_connected_labels; the
    components equal the JAX package's (the cases of
    tests/test_torch_graph.py test_split_components_match_jax)."""
    keys, counts = counted_table(k, seed=200 + k, genome_len=8000, b=0)
    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        monkeypatch.setattr(tcomp, name, wrapped)

    for name in ("walk_connected_labels", "star_connected_labels",
                 "hooking_connected_labels"):
        spy(name, getattr(tcomp, name))
    monkeypatch.setattr(tcomp, "_WALK_MIN", 0)
    got = components_to_numpy(tcomp.split_components(
        *table_from_jax(keys, counts, "cpu"), k, b1, b2))
    want = jcomp.split_components(keys, counts, k, b1, b2)
    assert calls[0] == "walk_connected_labels"
    assert "star_connected_labels" in calls
    assert "hooking_connected_labels" not in calls
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert np.array_equal(g.kmers, w.kmers)
        assert (g.weight, g.used_freq_threshold) == (
            w.weight, w.used_freq_threshold)


def _defs(name):
    """The port's modules that define a function ``name``."""
    out = []
    for path in PORT.rglob("*.py"):
        tree = ast.parse(path.read_text())
        if any(isinstance(n, ast.FunctionDef) and n.name == name
               for n in ast.walk(tree)):
            out.append(path.relative_to(PORT).as_posix())
    return out


def test_star_rewrite_is_written_once(tmp_path, monkeypatch):
    """_star_emit and its round loop have one definition, in
    graph/components.py, and both labellers run it."""
    from metafast_tpu_torch.parallel import components as pcomp
    from metafast_tpu_torch.parallel import distributed as D

    assert _defs("_star_emit") == ["graph/components.py"]
    assert _defs("_star_contract") == ["graph/components.py"]
    assert pcomp._star_contract is tcomp._star_contract
    rounds = []
    emit = tcomp._star_emit

    def counted(edges, large):
        rounds.append(large)
        return emit(edges, large)

    monkeypatch.setattr(tcomp, "_star_emit", counted)
    nbr, active = _random_graph(0)
    tn, ta = torch.from_numpy(nbr.astype(np.int64)), torch.from_numpy(active)
    single = tcomp.star_connected_labels(tn, ta)
    n_single = len(rounds)
    mesh = D.initialize(1, 0, f"file://{tmp_path / 'store'}", "cpu")
    try:
        sharded = pcomp.sharded_connected_labels(tn, ta, mesh)
    finally:
        D.shutdown()
    assert n_single >= 2 and len(rounds) - n_single >= 2
    assert torch.equal(single, sharded)

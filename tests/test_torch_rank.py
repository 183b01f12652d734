"""The port's splitter-walk list ranking (graph/rank.chain_rank) against
the JAX package's, an exact walk oracle and pointer doubling.

Every comparison is exact: reached on every valid row, term and dist on
the reached rows (on cycle rows both are unspecified in both packages),
and the walks as a partition of the nodes: the same node sets, with the
pass-1 walk ids equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metafast_tpu.graph import rank as jrank
from metafast_tpu_torch.graph import contigs as tcontigs
from metafast_tpu_torch.graph import dbg as tdbg
from metafast_tpu_torch.graph import rank as trank
from metafast_tpu_torch.state import table_from_jax
from test_rank import _random_forest, _walk_oracle
from torch_helpers import counted_table


def _rank(succ, valid=None, need_rank=True):
    succ = np.asarray(succ, dtype=np.int64)
    if valid is None:
        valid = np.ones(len(succ), bool)
    return trank.chain_rank(torch.from_numpy(succ), torch.from_numpy(valid),
                            need_rank=need_rank)


def _same_partition(a, b):
    """Two labelings of the nodes define the same partition."""
    pairs = np.unique(np.stack([a, b]), axis=1)
    return (pairs.shape[1] == len(np.unique(a)) == len(np.unique(b)))


def _assert_oracle(r, succ):
    o_term, o_dist, o_reached = _walk_oracle(succ)
    reached = r["reached"].numpy()
    assert np.array_equal(reached, o_reached)
    assert np.array_equal(r["term"].numpy()[o_reached], o_term[o_reached])
    assert np.array_equal(r["dist"].numpy()[o_reached], o_dist[o_reached])


def _assert_jax(r, succ, valid):
    j = jrank.chain_rank(jnp.asarray(succ.astype(np.int32)),
                         jnp.asarray(valid))
    reached = r["reached"].numpy()
    assert np.array_equal(reached[valid], np.asarray(j["reached"])[valid])
    m = reached & valid
    assert np.array_equal(r["term"].numpy()[m], np.asarray(j["term"])[m])
    assert np.array_equal(r["dist"].numpy()[m], np.asarray(j["dist"])[m])
    tw, jw = r["walkid"].numpy(), np.asarray(j["walkid"])
    assert np.array_equal(tw < 0, jw < 0)
    assert _same_partition(tw[valid], jw[valid])
    n_pass1 = int((trank._start_mask(torch.from_numpy(succ),
                                     torch.from_numpy(valid))).sum())
    p1 = tw < n_pass1
    assert np.array_equal(tw[p1], jw[p1])
    # cycle walks follow the pass-1 walks in both packages
    assert (jw[~p1 & valid] >= n_pass1).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chain_rank_matches_oracle_and_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        n = int(rng.integers(60, 4000))
        succ = _random_forest(rng, n).astype(np.int64)
        valid = np.ones(n, bool)
        r = _rank(succ, valid)
        _assert_oracle(r, succ)
        _assert_jax(r, succ, valid)
        assert (r["walkid"].numpy() >= 0).all()
        assert r["n_walks"] == int(r["walkid"].max()) + 1


def _dbg_succ(k, seed, palindromes):
    keys, counts = counted_table(k, seed, genome_len=3000,
                                 palindromes=palindromes)
    tkeys, _ = table_from_jax(keys, counts, "cpu")
    t = tdbg.neighbor_tables(tkeys, k)
    succ, _, _ = tcontigs._succ_from_tables(tkeys, t["left"], t["right"], k)
    return succ


@pytest.mark.parametrize("k,palindromes", [(5, 2), (11, 0), (16, 3),
                                           (31, 0)])
def test_chain_rank_matches_doubling_on_dbg(k, palindromes):
    succ = _dbg_succ(k, 300 + k, palindromes)
    valid = torch.ones(succ.numel(), dtype=torch.bool)
    r = trank.chain_rank(succ, valid)
    term, dist, reached = tcontigs._doubling(succ)
    assert torch.equal(r["reached"], reached)
    assert torch.equal(r["term"][reached], term[reached])
    assert torch.equal(r["dist"][reached], dist[reached])
    assert reached.any()
    _assert_jax(r, succ.numpy(), valid.numpy())


# JAX chain_rank fails on the first list: its cycle pass slices a
# _pow2(n_missing) = 512 wide buffer out of 456 nodes (TypeError)
@pytest.mark.parametrize("lens,with_jax", [
    ([1, 2, 3, 5, 8, 40, 97, 300], False),
    ([1, 2, 3, 5, 8, 40, 97, 300, 568], True),
])
def test_chain_rank_all_cycles(lens, with_jax):
    """Cycles only (no head): some hold a sampled start, the rest are
    ranked by the cycle pass alone; nothing is reached."""
    succ = []
    base = 0
    for n in lens:
        succ += [base + (i + 1) % n for i in range(n)]
        base += n
    succ = np.array(succ, np.int64)
    valid = np.ones(len(succ), bool)
    r = _rank(succ, valid)
    assert not r["reached"].any()
    assert (r["walkid"].numpy() >= 0).all()
    assert r["n_walks"] > int(trank._start_mask(
        torch.from_numpy(succ), torch.from_numpy(valid)).sum())
    _assert_oracle(r, succ)
    if with_jax:
        _assert_jax(r, succ, valid)


def test_chain_rank_invalid_rows():
    """Invalid rows are left out of every walk."""
    rng = np.random.default_rng(5)
    succ = _random_forest(rng, 500).astype(np.int64)
    valid = rng.random(500) < 0.8
    succ[~valid] = -1
    succ[np.isin(succ, np.nonzero(~valid)[0])] = -1
    r = _rank(succ, valid)
    w = r["walkid"].numpy()
    assert (w[~valid] == -1).all() and (w[valid] >= 0).all()
    assert not r["reached"].numpy()[~valid].any()
    assert (r["term"].numpy()[~valid] == -1).all()
    _assert_jax(r, succ, valid)


@pytest.mark.parametrize("succ,want", [
    ([], ([], [], [])),
    ([-1], ([0], [0], [True])),
    ([1, -1], ([1, 1], [1, 0], [True, True])),
])
def test_chain_rank_tiny(succ, want):
    r = _rank(np.array(succ, np.int64))
    term, dist, reached = want
    assert r["term"].tolist() == term
    assert r["dist"].tolist() == dist
    assert r["reached"].tolist() == reached
    assert r["n_walks"] == (1 if succ else 0)


def test_chain_rank_without_rank():
    rng = np.random.default_rng(7)
    succ = _random_forest(rng, 2000).astype(np.int64)
    full = _rank(succ)
    walks = _rank(succ, need_rank=False)
    assert set(walks) == {"walkid", "n_walks", "res_stop", "res_term",
                          "segments"}
    assert torch.equal(walks["walkid"], full["walkid"])
    assert torch.equal(walks["res_stop"], full["res_stop"])
    assert torch.equal(walks["res_term"], full["res_term"])
    assert walks["n_walks"] == full["n_walks"]


def test_chain_rank_raises_on_a_walk_past_n_steps():
    """A successor graph that is not injective can trap a walk on a
    cycle with no start: the n-step bound raises."""
    ids = torch.arange(1, 200)
    a, b = (int(x) for x in ids[~trank._sampled(ids)][:2])
    succ = np.full(max(a, b) + 1, -1, np.int64)
    succ[0] = a
    succ[a] = b
    succ[b] = a
    with pytest.raises(RuntimeError, match="not injective"):
        _rank(succ)

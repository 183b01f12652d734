"""The port's int64 k-mer arithmetic against metafast_tpu.core.bitpack.

Inputs are made with numpy, the JAX ops run on (hi, lo) uint32 pairs on
the CPU, and their results are joined to int64 with state.join_pairs.
All of it is integer work: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metafast_tpu.core import bitpack as jbp
from metafast_tpu_torch.core import bitpack as tbp
from metafast_tpu_torch.state import join_pairs

KS = [1, 15, 16, 17, 31]


def _keys(k, n=2000, seed=0):
    rng = np.random.default_rng(seed + k)
    top = 4 ** k
    keys = rng.integers(0, top, n, dtype=np.int64)
    return np.concatenate([[0, top - 1, top // 2], keys]).astype(np.int64)


def _split(keys):
    u = keys.astype(np.uint64)
    return (jnp.asarray((u >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((u & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def _join(hi, lo):
    return join_pairs(np.asarray(hi), np.asarray(lo))


@pytest.mark.parametrize("k", KS)
def test_rc_and_canonical(k):
    keys = _keys(k)
    hi, lo = _split(keys)
    t = torch.from_numpy(keys)
    assert np.array_equal(tbp.rc(t, k).numpy(), _join(*jbp.rc(hi, lo, k)))
    assert np.array_equal(tbp.canonical(t, k).numpy(),
                          _join(*jbp.canonical(hi, lo, k)))


@pytest.mark.parametrize("k", KS)
def test_shifts(k):
    keys = _keys(k, seed=1)
    hi, lo = _split(keys)
    t = torch.from_numpy(keys)
    nuc = np.random.default_rng(k).integers(0, 4, len(keys)).astype(np.uint32)
    tn = torch.from_numpy(nuc.astype(np.int64))
    assert np.array_equal(tbp.shift_right(t, tn, k).numpy(),
                          _join(*jbp.shift_right(hi, lo, jnp.asarray(nuc), k)))
    assert np.array_equal(tbp.shift_left(t, tn, k).numpy(),
                          _join(*jbp.shift_left(hi, lo, jnp.asarray(nuc), k)))
    for c in range(4):
        assert np.array_equal(tbp.shift_right(t, c, k).numpy(),
                              _join(*jbp.shift_right(hi, lo, c, k)))
        assert np.array_equal(tbp.shift_left(t, c, k).numpy(),
                              _join(*jbp.shift_left(hi, lo, c, k)))


@pytest.mark.parametrize("k", KS)
def test_nucleotides_and_sentinel(k):
    keys = _keys(k, seed=2)
    hi, lo = _split(keys)
    t = torch.from_numpy(keys)
    assert np.array_equal(tbp.first_nuc(t, k).numpy(),
                          np.asarray(jbp.first_nuc(hi, lo, k)))
    assert np.array_equal(tbp.last_nuc(t).numpy(),
                          np.asarray(jbp.last_nuc(lo)))
    nuc = np.arange(4, dtype=np.uint32)
    assert np.array_equal(tbp.complement_nuc(torch.arange(4)).numpy(),
                          np.asarray(jbp.complement_nuc(jnp.asarray(nuc))))
    # the JAX sentinel pair joins to the port's SENTINEL, which sorts last
    shi = np.where(np.arange(len(keys)) % 3 == 0, 0xFFFFFFFF,
                   np.asarray(hi)).astype(np.uint32)
    slo = np.where(np.arange(len(keys)) % 3 == 0, 0xFFFFFFFF,
                   np.asarray(lo)).astype(np.uint32)
    joined = join_pairs(shi, slo)
    assert np.array_equal(
        tbp.is_sentinel(torch.from_numpy(joined)).numpy(),
        np.asarray(jbp.is_sentinel(jnp.asarray(shi), jnp.asarray(slo))))
    assert joined.max() == tbp.SENTINEL
    assert np.array_equal(np.argsort(joined, kind="stable"),
                          np.lexsort((slo, shi)))

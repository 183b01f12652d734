"""The port's blocked bitonic sort against the JAX package, on the CPU.

The cases of tests/test_psort.py go through metafast_tpu.ops.psort
(Pallas tile kernel in interpret mode, log_block=10) and through the
port's sort_arrays_blocked, whose CPU path is the plain version of the
CUDA kernel.  Keys come from state.join_pairs(hi, lo); keys and payloads
must be equal exactly, the order among equal keys included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metafast_tpu.ops import psort as jpsort
from metafast_tpu_torch.ops import psort
from metafast_tpu_torch.state import join_pairs


def _rand_pairs(rng, n, hi_space=1 << 12, sentinel_frac=0.0):
    hi = rng.integers(0, hi_space, n).astype(np.uint32)
    lo = rng.integers(0, 1 << 16, n).astype(np.uint32)
    if sentinel_frac:
        m = rng.random(n) < sentinel_frac
        hi[m] = np.uint32(0xFFFFFFFF)
        lo[m] = np.uint32(0xFFFFFFFF)
    return hi, lo


def _sentinel(logn):
    hi, lo = _rand_pairs(np.random.default_rng(logn), 1 << logn,
                         sentinel_frac=0.1)
    return hi, lo, None


def _duplicates(seed=7):
    hi, lo = _rand_pairs(np.random.default_rng(seed), 1 << 12, hi_space=8)
    return hi, (lo % 4).astype(np.uint32)


def _unique_payload():
    perm = np.random.default_rng(3).permutation(1 << 12).astype(np.uint32)
    return (perm >> np.uint32(8), perm & np.uint32(0xFF),
            (perm * np.uint32(2654435761)).astype(np.uint32))


def _ordered(reverse):
    hi = np.arange(1 << 11, dtype=np.uint32) >> np.uint32(4)
    lo = np.arange(1 << 11, dtype=np.uint32)
    if reverse:
        hi, lo = hi[::-1].copy(), lo[::-1].copy()
    return hi, lo, None


CASES = {
    "sentinel_2^10": lambda: _sentinel(10),
    "sentinel_2^12": lambda: _sentinel(12),
    "sentinel_2^13": lambda: _sentinel(13),
    "duplicates": lambda: (*_duplicates(), None),
    "unique_payload": _unique_payload,
    "duplicates_distinct_payload": lambda: (
        *_duplicates(17), np.arange(1 << 12, dtype=np.uint32)),
    "sorted": lambda: _ordered(False),
    "reversed": lambda: _ordered(True),
}


def _jax_sort(hi, lo, pay, log_block):
    arrs = [jnp.asarray(hi), jnp.asarray(lo)]
    if pay is not None:
        arrs.append(jnp.asarray(pay))
    out = jpsort.sort_arrays_blocked(tuple(arrs), log_block=log_block,
                                     interpret=True)
    keys = join_pairs(np.asarray(out[0]), np.asarray(out[1]))
    return keys, (np.asarray(out[2]) if pay is not None else None)


def _port_sort(hi, lo, pay, log_block):
    arrs = [torch.from_numpy(join_pairs(hi, lo))]
    if pay is not None:
        arrs.append(torch.from_numpy(pay.astype(np.int64)))
    out = psort.sort_arrays_blocked(arrs, log_block=log_block)
    return out[0].numpy(), (out[1].numpy() if pay is not None else None)


@pytest.mark.parametrize("case", list(CASES))
def test_blocked_sort_matches_jax(case):
    hi, lo, pay = CASES[case]()
    want_keys, want_pay = _jax_sort(hi, lo, pay, 10)
    keys, got_pay = _port_sort(hi, lo, pay, 10)
    assert np.array_equal(keys, want_keys)
    assert np.array_equal(keys, np.sort(join_pairs(hi, lo)))
    if pay is not None:
        assert np.array_equal(got_pay, want_pay)


def test_tie_rule_follows_logical_block():
    """Equal keys stay put below 2**log_block and swap in ascending
    windows above it, so the payload order among ties depends on
    log_block; both settings must match JAX's."""
    hi, lo = _duplicates(17)
    pay = np.arange(1 << 12, dtype=np.uint32)
    pays = []
    for log_block in (10, 11):
        want_keys, want_pay = _jax_sort(hi, lo, pay, log_block)
        keys, got_pay = _port_sort(hi, lo, pay, log_block)
        assert np.array_equal(keys, want_keys)
        assert np.array_equal(got_pay, want_pay)
        pays.append(got_pay)
    assert not np.array_equal(pays[0], pays[1])


def test_sort_arrays_fallback_non_pow2():
    """n = 3000 takes torch.sort; JAX's lax.sort is unstable, so keys and
    per-key payload multisets are compared."""
    hi, lo = _rand_pairs(np.random.default_rng(11), 3000)
    pay = np.arange(3000, dtype=np.uint32)
    jh, jl, jp = jpsort.sort_arrays((jnp.asarray(hi), jnp.asarray(lo),
                                     jnp.asarray(pay)))
    want_keys = join_pairs(np.asarray(jh), np.asarray(jl))
    keys, got_pay = psort.sort_arrays(
        (torch.from_numpy(join_pairs(hi, lo)),
         torch.from_numpy(pay.astype(np.int64))))
    keys, got_pay = keys.numpy(), got_pay.numpy()
    assert np.array_equal(keys, want_keys)
    for kv in np.unique(keys):
        assert np.array_equal(np.sort(got_pay[keys == kv]),
                              np.sort(np.asarray(jp)[want_keys == kv]))


def test_negative_keys_match_torch_sort():
    """Signed int64 order, negative keys included."""
    rng = np.random.default_rng(5)
    # distinct keys, half of them negative, spread over 2**52
    keys = torch.from_numpy(
        (rng.permutation(1 << 11).astype(np.int64) - (1 << 10)) << 41)
    pay = torch.arange(1 << 11, dtype=torch.int32)
    got_keys, got_pay = psort.sort_arrays_blocked((keys, pay), log_block=8)
    want_keys, order = torch.sort(keys)
    assert torch.equal(got_keys, want_keys)
    assert torch.equal(got_pay, pay[order])
    assert got_pay.dtype == torch.int32


@pytest.mark.parametrize("n,log_block", [(3000, 10), (1 << 9, 10),
                                         (1 << 10, 0)])
def test_rejects_bad_length(n, log_block):
    with pytest.raises(ValueError):
        psort.sort_arrays_blocked((torch.zeros(n, dtype=torch.int64),),
                                  log_block=log_block)


def test_rejects_mismatched_payload_and_dtype():
    keys = torch.zeros(1 << 10, dtype=torch.int64)
    with pytest.raises(ValueError):
        psort.sort_arrays_blocked((keys, torch.zeros(5)), log_block=10)
    with pytest.raises(TypeError):
        psort.sort_arrays_blocked((keys.to(torch.int32),), log_block=10)

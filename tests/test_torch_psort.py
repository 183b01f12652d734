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


# ---------------------------------------------------------------------------
# The kernel's pass plan (csrc/psort.cu runs it; here it is checked on the
# CPU: the stages it covers, and a plain executor of its register groups)
# ---------------------------------------------------------------------------

def _network_stages(log_n):
    return [(ls, ld) for ls in range(1, log_n + 1)
            for ld in range(ls - 1, -1, -1)]


def _plan_stages(plan, log_n, log_tile, fuse):
    """The (log span, log distance) stages the plan runs, in order; a
    tile pass cuts each span's distances below the tile as
    csrc/psort.cu tile_pass does (psort._groups)."""
    lt = min(log_tile, log_n)
    out = []
    for p in plan:
        if p[0] == "global":
            out += [(p[1], ld) for ld in range(p[2], p[3] - 1, -1)]
            continue
        for ls in range(p[1], p[2] + 1):
            for hi, lo in psort._groups(min(ls, lt) - 1, 0, fuse):
                out += [(ls, ld) for ld in range(hi, lo - 1, -1)]
    return out


@pytest.mark.parametrize("fuse", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("log_tile", [12, 13, 14])
def test_plan_covers_the_network(log_tile, fuse):
    """Flattened to (span, distance) stages, the plan is the network's
    stage list, each stage once and in order, for every n up to 2**31;
    global passes hold 1..fuse distances, all at or above the tile."""
    for log_n in range(1, 32):
        lt = min(log_tile, log_n)
        plan = psort._plan(log_n, log_tile, fuse)
        assert _plan_stages(plan, log_n, log_tile, fuse) == \
            _network_stages(log_n), log_n
        assert plan[0] == ("tile", 1, lt)
        glob = [p for p in plan if p[0] == "global"]
        assert all(p[3] >= lt and p[2] < p[1] and 1 <= p[2] - p[3] + 1
                   <= fuse for p in glob)
        assert len(glob) == sum(-(-(ls - lt) // fuse)
                                for ls in range(lt + 1, log_n + 1))
        assert len(plan) - len(glob) == 1 + max(0, log_n - lt)


def test_plan_at_2_27_has_at_most_50_passes():
    """42 HBM round trips (28 global, 14 tile) at the defaults, against
    136 (120 + 16) for one stage per pass and a 2**12 tile."""
    plan = psort._plan(27)
    assert (psort.LOG_TILE, psort.FUSE) == (14, 4)
    assert sum(p[0] == "global" for p in plan) == 28
    assert sum(p[0] == "tile" for p in plan) == 14
    assert len(psort._plan(27, 12, 1)) == 136


def _run_group(k, x, offs, base, hi, lo, log_span, log_block):
    """One register group as a thread of the kernel runs it: the sets'
    elements gathered to [..., 2**g], stage by stage, scattered back."""
    g = hi - lo + 1
    kk, xx = k[..., offs], x[..., offs]
    up = (((base >> log_span) & 1) == 0)[..., None]
    for q in range(g - 1, -1, -1):
        j = [i for i in range(1 << g) if not i & (1 << q)]
        m = [i | (1 << q) for i in j]
        a, b = kk[..., j], kk[..., m]
        up_rule = a > b if lo + q < log_block else a >= b
        swap = torch.where(up, up_rule, a < b)
        kk[..., j], kk[..., m] = (torch.where(swap, b, a),
                                  torch.where(swap, a, b))
        xa, xb = xx[..., j], xx[..., m]
        xx[..., j], xx[..., m] = (torch.where(swap, xb, xa),
                                  torch.where(swap, xa, xb))
    k[..., offs], x[..., offs] = kk, xx


def _set_bases(n_sets, lo, g):
    w = torch.arange(n_sets)
    return ((w >> lo) << (lo + g)) | (w & ((1 << lo) - 1))


def _run_plan_torch(keys, log_block, log_tile, fuse):
    """The kernel's schedule in torch ops: every pass of the plan, every
    register group of a pass with the kernel's set indexing (tile-local
    inside a tile pass, whole-array in a global pass)."""
    n = keys.numel()
    log_n = n.bit_length() - 1
    lt = min(log_tile, log_n)
    k = keys.clone()
    x = torch.arange(n, dtype=torch.int32)
    for p in psort._plan(log_n, log_tile, fuse):
        if p[0] == "global":
            _, ls, hi, lo = p
            b = _set_bases(n >> (hi - lo + 1), lo, hi - lo + 1)
            offs = b[:, None] + (torch.arange(1 << (hi - lo + 1)) << lo)
            _run_group(k, x, offs, b, hi, lo, ls, log_block)
            continue
        kt, xt = k.view(-1, 1 << lt), x.view(-1, 1 << lt)
        tile_base = torch.arange(n >> lt)[:, None] << lt
        for ls in range(p[1], p[2] + 1):
            for hi, lo in psort._groups(min(ls, lt) - 1, 0, fuse):
                g = hi - lo + 1
                b = _set_bases(1 << (lt - g), lo, g)
                offs = b[:, None] + (torch.arange(1 << g) << lo)
                _run_group(kt, xt, offs, tile_base + b, hi, lo, ls,
                           log_block)
    return k, x


def _heavy_ties(log_n, seed=0):
    rng = np.random.default_rng(seed + log_n)
    n = 1 << log_n
    keys = np.where(rng.random(n) < 0.3, rng.integers(0, 1 << 62, n),
                    rng.integers(0, 8, n))
    return torch.from_numpy(keys.astype(np.int64))


def _sentinels(log_n):
    hi, lo = _rand_pairs(np.random.default_rng(log_n), 1 << log_n,
                         hi_space=16, sentinel_frac=0.2)
    return torch.from_numpy(join_pairs(hi, lo))


# (log_n, log_tile, fuse, log_block): n = 2**10 with a 2**6 tile has tile
# distances 0..5 (groups of 3: bits 5..3, 2..0) and global ones 6..9
# (span 2**10: bits 9..7, then 6).  log_block 1 lies below the tile's
# distances, 4 inside them (and splits the group 5..3), 8 above the tile
# (and splits the global group 9..7), 10 above every distance.  The
# defaults (2**14 tile, groups of 4) at 2**16: 13 splits a tile group,
# 15 the global group 15..14.
PLAN_CASES = [(10, 6, 3, lb) for lb in (1, 4, 8, 10)] + [
    (9, 6, 4, 5), (7, 3, 2, 2), (6, 12, 4, 3), (1, 14, 4, 1),
    (16, 14, 4, 13), (16, 14, 4, 15), (15, 13, 5, 14)]


@pytest.mark.parametrize("data", ["heavy_ties", "sentinels"])
@pytest.mark.parametrize("log_n,log_tile,fuse,log_block", PLAN_CASES)
def test_plan_executor_matches_network(log_n, log_tile, fuse, log_block,
                                       data):
    keys = (_heavy_ties if data == "heavy_ties" else _sentinels)(log_n)
    want_keys, want_perm = psort._network_torch(keys, log_block)
    got_keys, got_idx = _run_plan_torch(keys, log_block, log_tile, fuse)
    assert torch.equal(got_keys, want_keys)
    assert torch.equal(got_idx.long(), want_perm)


def test_rejects_mismatched_payload_and_dtype():
    keys = torch.zeros(1 << 10, dtype=torch.int64)
    with pytest.raises(ValueError):
        psort.sort_arrays_blocked((keys, torch.zeros(5)), log_block=10)
    with pytest.raises(TypeError):
        psort.sort_arrays_blocked((keys.to(torch.int32),), log_block=10)

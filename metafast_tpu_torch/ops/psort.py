"""Blocked bitonic sort of an int64 key with payloads: plain version, kernel.

Counterpart of metafast_tpu/ops/psort.py.  The JAX package sorts (hi, lo)
uint32 pairs; the port sorts one int64 key, ordered as signed int64 (k-mer
keys stay below 2**62 and the sentinel pair maps to SENTINEL, see
state.join_pairs, so the order is the same).  ``arrs[1:]`` are payloads of
any dtype.

The network is the textbook one: for each span s = 2, 4, .., n and each
distance d = s/2, .., 1, element i (with i & d == 0) is compared with
i + d, ascending iff i & s == 0.  The JAX package runs the stages with
d < 2**log_block inside a VMEM tile and the others as XLA exchanges, and
the two treat equal keys differently:

  * d < 2**log_block (the tile, psort.py:87-93): equal keys stay put;
  * d >= 2**log_block (the exchange, psort.py:157-161): in an ascending
    window equal keys swap, in a descending one they stay.

Keys come out the same either way, but the payload order among equal keys
depends on that rule, so the port applies it per stage from the logical
``log_block``: the kernel's physical tile size never decides it.

``sort_arrays_blocked`` sends CUDA tensors to the hand kernel
(csrc/psort.cu), which sorts (key, int32 index) pairs; the payloads are
gathered by the index afterwards, which gives what carrying them would,
since every decision of the network reads keys only.  The kernel's
schedule is ``_plan``: tile passes over 2**LOG_TILE elements in shared
memory and global passes of up to FUSE stages each, both running their
stages in register groups of at most FUSE distance bits (``_groups``);
the wrapper launches one entry point per pass.  CPU tensors go to
``sort_arrays_blocked_torch``.  The JAX counter sorts with jax.lax.sort and
so does the port's (torch.sort): this module has no caller on the
counting path.
"""

from __future__ import annotations

import ctypes
import functools

import torch

# smallest n that takes the blocked path in sort_arrays, and the default
# tie-rule boundary (the JAX package's VMEM tile of 2**17 elements)
LOG_BLOCK = 17
# the kernel's shared-memory tile (2**14 x 12 B, padded: 202 KB of the
# H100's 227 KB) and the stages per register group, chosen by timing
# T = 2**13 / 2**14 and r = 3..5 at 2**27 keys on the card (PERF.md)
LOG_TILE = 14
FUSE = 4


def _check(arrs, log_block: int) -> tuple[torch.Tensor, ...]:
    arrs = tuple(arrs)
    if not arrs:
        raise ValueError("sort needs at least the key array")
    keys = arrs[0]
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64, got {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    n = keys.numel()
    for a in arrs[1:]:
        if a.shape != keys.shape or a.device != keys.device:
            raise ValueError("payloads must match the keys in shape and "
                             "device")
    if log_block < 1 or n < (1 << log_block) or n & (n - 1) or n > 1 << 31:
        raise ValueError(f"n must be a power of two in [2**log_block, 2**31]"
                         f" with log_block >= 1, got n={n}, "
                         f"log_block={log_block}")
    return arrs


def _gather(arrs, keys: torch.Tensor, perm: torch.Tensor):
    return (keys,) + tuple(a[perm] for a in arrs[1:])


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path and the kernel's reference on the card)
# ---------------------------------------------------------------------------

def _network_torch(keys: torch.Tensor, log_block: int):
    """The network over (keys, int64 index): one compare-exchange per
    stage on a [windows, 2, d] view, as _xla_exchange (psort.py:142-165)."""
    n = keys.numel()
    log_n = n.bit_length() - 1
    perm = torch.arange(n, dtype=torch.int64, device=keys.device)
    for log_s in range(1, log_n + 1):
        for log_d in range(log_s - 1, -1, -1):
            d = 1 << log_d
            kv = keys.view(-1, 2, d)
            pv = perm.view(-1, 2, d)
            a, b = kv[:, 0], kv[:, 1]
            # s > d: the span bit of i = w*2d + j comes from w alone
            w = torch.arange(n >> (log_d + 1), device=keys.device)
            up = (((w << (log_d + 1)) & (1 << log_s)) == 0)[:, None]
            if log_d < log_block:
                swap = torch.where(up, a > b, a < b)
            else:
                swap = torch.where(up, a >= b, a < b)
            keys = torch.stack([torch.where(swap, b, a),
                                torch.where(swap, a, b)], 1).view(n)
            pa, pb = pv[:, 0], pv[:, 1]
            perm = torch.stack([torch.where(swap, pb, pa),
                                torch.where(swap, pa, pb)], 1).view(n)
    return keys, perm


def sort_arrays_blocked_torch(arrs, log_block: int = LOG_BLOCK):
    """The blocked bitonic network in torch ops: (keys, *payloads) sorted
    by keys, ties ordered as the JAX package's sort_arrays_blocked."""
    arrs = _check(arrs, log_block)
    keys, perm = _network_torch(arrs[0], log_block)
    return _gather(arrs, keys, perm)


# ---------------------------------------------------------------------------
# The kernel's pass plan
# ---------------------------------------------------------------------------

def _groups(ld_hi: int, ld_lo: int, fuse: int) -> list[tuple[int, int]]:
    """Distance bits ld_hi..ld_lo (descending) cut into register groups
    [(hi, lo), ...] of ``fuse`` bits from the top down, the last group
    taking the remainder.  csrc/psort.cu tile_pass cuts a tile's distances
    the same way."""
    out = []
    hi = ld_hi
    while hi >= ld_lo:
        out.append((hi, max(hi - fuse + 1, ld_lo)))
        hi = out[-1][1] - 1
    return out


def _plan(log_n: int, log_tile: int = LOG_TILE, fuse: int = FUSE):
    """The kernel's passes in order, each one HBM round trip:
    ("tile", ls_lo, ls_hi) runs spans 2**ls_lo..2**ls_hi at every distance
    below the tile 2**min(log_tile, log_n); ("global", ls, ld_hi, ld_lo)
    runs span 2**ls at distances 2**ld_hi..2**ld_lo (at most ``fuse``)."""
    lt = min(log_tile, log_n)
    plan = [("tile", 1, lt)]
    for ls in range(lt + 1, log_n + 1):
        plan += [("global", ls, hi, lo) for hi, lo in _groups(ls - 1, lt,
                                                               fuse)]
        plan.append(("tile", ls, ls))
    return plan


# ---------------------------------------------------------------------------
# Wrapper: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------

@functools.cache
def _entry_points():
    from ..kernels.build import load

    lib = load("psort")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.psort_tile_pass.argtypes = [ptr, ptr, ptr, i64] + [i32] * 6 + [ptr]
    lib.psort_tile_pass.restype = i32
    lib.psort_global_pass.argtypes = [ptr, ptr, i64] + [i32] * 4 + [ptr]
    lib.psort_global_pass.restype = i32
    return lib.psort_tile_pass, lib.psort_global_pass


def _sort_kernel(keys: torch.Tensor, log_block: int,
                 log_tile: int = LOG_TILE, fuse: int = FUSE,
                 after_pass=None):
    """(sorted keys, int32 index) from the kernel, one launch per pass of
    ``_plan``, on the current stream without a synchronise;
    ``after_pass(p)``, if given, is called after each pass is launched."""
    tile, glob = _entry_points()
    n = keys.numel()
    log_n = n.bit_length() - 1
    lt = min(log_tile, log_n)
    out = torch.empty_like(keys)
    idx = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    for i, p in enumerate(_plan(log_n, log_tile, fuse)):
        if p[0] == "tile":
            src = keys if i == 0 else out
            err = tile(src.data_ptr(), out.data_ptr(), idx.data_ptr(), n, lt,
                       p[1], p[2], log_block, fuse, int(i == 0), stream)
        else:
            err = glob(out.data_ptr(), idx.data_ptr(), n, p[1], p[2], p[3],
                       log_block, stream)
        if err != 0:
            raise RuntimeError(f"psort {p[0]} pass {p} failed to launch: "
                               f"CUDA error {err}")
        if after_pass is not None:
            after_pass(p)
    return out, idx


def sort_arrays_blocked(arrs, log_block: int = LOG_BLOCK):
    """(keys, *payloads) sorted by the int64 keys through the blocked
    bitonic network; n a power of two >= 2**log_block.

    CUDA tensors go through the hand kernel (csrc/psort.cu, the passes of
    ``_plan``), launched on the current stream without a synchronise; CPU
    tensors through ``sort_arrays_blocked_torch``.
    ``sort_arrays_blocked.launches`` counts kernel calls (one per sort).
    """
    arrs = _check(arrs, log_block)
    keys = arrs[0]
    if keys.device.type == "cpu":
        return sort_arrays_blocked_torch(arrs, log_block)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("sort_arrays_blocked needs contiguous keys")
    with torch.cuda.device(keys.device):
        out, idx = _sort_kernel(keys, log_block)
    sort_arrays_blocked.launches += 1
    return _gather(arrs, out, idx)


sort_arrays_blocked.launches = 0


def sort_arrays(arrs):
    """(keys, *payloads) sorted by keys: the blocked kernel on CUDA when n
    is a power of two >= 2**LOG_BLOCK, else a stable torch.sort (the JAX
    package's lax.sort there is unstable, so only the per-key payload
    multisets are common to both)."""
    arrs = tuple(arrs)
    n = arrs[0].numel()
    if (arrs[0].device.type == "cuda" and n >= 1 << LOG_BLOCK
            and not n & (n - 1)):
        return sort_arrays_blocked(arrs)
    keys, order = torch.sort(arrs[0], stable=True)
    return _gather(arrs, keys, order)

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
since every decision of the network reads keys only.  CPU tensors go to
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
# Wrapper: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------

@functools.cache
def _launcher():
    from ..kernels.build import load

    fn = load("psort").psort_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sort_arrays_blocked(arrs, log_block: int = LOG_BLOCK):
    """(keys, *payloads) sorted by the int64 keys through the blocked
    bitonic network; n a power of two >= 2**log_block.

    CUDA tensors go through the hand kernel (csrc/psort.cu), launched on
    the current stream without a synchronise; CPU tensors through
    ``sort_arrays_blocked_torch``.  ``sort_arrays_blocked.launches``
    counts kernel calls.
    """
    arrs = _check(arrs, log_block)
    keys = arrs[0]
    if keys.device.type == "cpu":
        return sort_arrays_blocked_torch(arrs, log_block)
    if keys.device.type != "cuda":
        raise ValueError(f"unsupported device {keys.device}")
    if not keys.is_contiguous():
        raise ValueError("sort_arrays_blocked needs contiguous keys")
    out = torch.empty_like(keys)
    idx = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        err = _launcher()(
            keys.data_ptr(), out.data_ptr(), idx.data_ptr(), keys.numel(),
            log_block, torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"psort kernel launch failed: CUDA error {err}")
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

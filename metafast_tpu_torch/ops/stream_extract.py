"""Flat-stream canonical k-mer extraction: host layout, plain version, kernel.

Counterpart of metafast_tpu/ops/stream_extract.py.  The read set is one
flat 2-bit code stream packed 16 codes per u32 word (code j at bits 2j)
in word columns [C, 256], plus a validity mask word per stream word (bit
r: the window starting at code 16w + r lies inside one read).  Two
layouts:

  * "stream3" (the counting path): every read starts at a fresh word and
    only words holding valid window starts are emitted; the next one and
    two words of the same read ride as separate arrays w1, w2.
  * "columns": one slot per code position; w1 and w2 are the next rows of
    the same 256-row column, whose rows 254-255 repeat the next column's
    first two words (mask 0 there).

Both host layouts come from the native C++ builders of the JAX package
(jax-free).  Extraction emits int64 keys [16, C, 256], phase-major, with
SENTINEL where the mask bit is 0: on CUDA tensors through the hand kernel
csrc/stream_extract.cu, on CPU tensors through ``stream_extract_torch``.
Counting sorts the keys, so only their multiset matters downstream.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.bitpack import SENTINEL
from ..utils.native import native_library

ROWS = 256          # column height
PAYLOAD = ROWS - 2  # payload words per column in the "columns" layout
LAYOUTS = ("stream3", "columns")
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host layout (native builders)
# ---------------------------------------------------------------------------

def stream_cols(n_codes: int) -> int:
    """Columns of the "columns" layout for n_codes codes."""
    n_words = -(-n_codes // 16)
    return max(1, -(-n_words // PAYLOAD))


def stream3_cols(lengths: np.ndarray, k: int) -> int:
    """Columns of the "stream3" layout: ceil((len-k+1)/16) words per read."""
    nw = np.maximum(np.asarray(lengths, dtype=np.int64) - (k - 1), 0)
    n_words = int(((nw + 15) // 16).sum())
    return max(1, -(-n_words // ROWS))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_stream3(codes: np.ndarray, lengths: np.ndarray, k: int):
    """Pack reads into the compact layout: (w0, w1, w2, vm) u32 [C, 256]."""
    lib = native_library()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    shape = (stream3_cols(lengths, k), ROWS)
    w0, w1, w2, vm = (np.zeros(shape, dtype=np.uint32) for _ in range(4))
    lib.build_stream3_cols(
        _ptr(codes, ctypes.c_uint8), len(codes),
        _ptr(lengths, ctypes.c_int32), len(lengths), k,
        _ptr(w0, ctypes.c_uint32), _ptr(w1, ctypes.c_uint32),
        _ptr(w2, ctypes.c_uint32), _ptr(vm, ctypes.c_uint32),
        shape[0] * ROWS)
    return w0, w1, w2, vm


def build_stream(codes: np.ndarray, lengths: np.ndarray, k: int):
    """Pack reads into the overlapping-column layout: (words, vm) u32
    [C, 256]."""
    lib = native_library()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n_cols = stream_cols(len(codes))
    words = np.empty((n_cols, ROWS), dtype=np.uint32)
    vm = np.zeros((n_cols, ROWS), dtype=np.uint32)
    lib.build_stream_cols(
        _ptr(codes, ctypes.c_uint8), len(codes),
        _ptr(lengths, ctypes.c_int32), len(lengths), k,
        _ptr(words, ctypes.c_uint32), _ptr(vm, ctypes.c_uint32), n_cols)
    return words, vm


def to_device(arrays, device: torch.device) -> list[torch.Tensor]:
    """Host u32 arrays -> int32 device tensors (same bits).

    CUDA uploads go through pinned host memory with non_blocking copies
    on the current stream."""
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out.append(t)
    return out


# ---------------------------------------------------------------------------
# Plain PyTorch version (CPU path and the kernel's reference on the card)
# ---------------------------------------------------------------------------

def _u32(w: torch.Tensor) -> torch.Tensor:
    """int32/uint32 words as int64 in [0, 2**32)."""
    return w.to(torch.int64) & _M32


def _rev2(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 16 2-bit fields of each 32-bit value (int64 holder)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & _M32


def _next_rows(w: torch.Tensor, s: int) -> torch.Tensor:
    """Row (r + s) % 256 of each word's own column."""
    return torch.roll(w, -s, dims=1)


def stream_extract_torch(w0, w1, w2, vm, k: int,
                         layout: str = "stream3") -> torch.Tensor:
    """The window math of metafast_tpu/ops/stream_extract.py:66-119 in
    u32 arithmetic held in int64 tensors: int64 keys [16, C, 256]."""
    _check_layout(layout, w1, w2)
    w0 = _u32(w0)
    if layout == "columns":
        w1, w2 = _next_rows(w0, 1), _next_rows(w0, 2)
    else:
        w1, w2 = _u32(w1), _u32(w2)
    vm = _u32(vm)
    r0, r1, r2 = _rev2(w0), _rev2(w1), _rev2(w2)
    n0, n1, n2 = (~w0) & _M32, (~w1) & _M32, (~w2) & _M32
    s_down = 64 - 2 * k
    zero = torch.zeros_like(w0)
    keys = []
    for r in range(16):
        # forward: bits [2r, 2r+64) of the pair-reversed stream
        if r == 0:
            a_hi, a_lo = r0, r1
        else:
            a_hi = ((r0 << 2 * r) | (r1 >> (32 - 2 * r))) & _M32
            a_lo = ((r1 << 2 * r) | (r2 >> (32 - 2 * r))) & _M32
        # align the window (top 2k bits) to the bottom
        if s_down < 32:
            fh = a_hi >> s_down
            fl = ((a_lo >> s_down) | (a_hi << (32 - s_down))) & _M32
        elif s_down == 32:
            fh, fl = zero, a_hi
        else:
            fh, fl = zero, a_hi >> (s_down - 32)
        # reverse complement: bits [2r, 2r+2k) of the complemented
        # little-endian stream
        if r == 0:
            c_lo, c_hi = n0, n1
        else:
            c_lo = ((n0 >> 2 * r) | (n1 << (32 - 2 * r))) & _M32
            c_hi = ((n1 >> 2 * r) | (n2 << (32 - 2 * r))) & _M32
        if k > 16:
            rh, rl = c_hi & ((1 << (2 * k - 32)) - 1), c_lo
        elif k == 16:
            rh, rl = zero, c_lo
        else:
            rh, rl = zero, c_lo & ((1 << (2 * k)) - 1)
        take_rc = (rh < fh) | ((rh == fh) & (rl < fl))
        key = torch.where(take_rc, (rh << 32) | rl, (fh << 32) | fl)
        valid = ((vm >> r) & 1) != 0
        keys.append(torch.where(valid, key, SENTINEL))
    return torch.stack(keys)


# ---------------------------------------------------------------------------
# Wrapper: the kernel on CUDA tensors, the plain version on CPU tensors
# ---------------------------------------------------------------------------

def _check_layout(layout: str, w1, w2) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
    if (layout == "stream3") != (w1 is not None and w2 is not None):
        raise ValueError(f"layout {layout!r}: w1 and w2 must be given "
                         "exactly for 'stream3'")


def _check_inputs(arrays, k: int) -> None:
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    shape = arrays[0].shape
    if len(shape) != 2 or shape[1] != ROWS:
        raise ValueError(f"words must be [C, {ROWS}], got {tuple(shape)}")
    for a in arrays:
        if a.shape != shape or a.device != arrays[0].device:
            raise ValueError("word and mask arrays differ in shape or device")
        if a.dtype not in (torch.int32, torch.uint32):
            raise TypeError(f"words must be int32 or uint32, got {a.dtype}")


@functools.cache
def _launcher():
    from ..kernels.build import load

    fn = load("stream_extract").stream_extract_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream_extract(w0, w1, w2, vm, k: int,
                   layout: str = "stream3") -> torch.Tensor:
    """Canonical keys of every window: int64 [16, C, 256], phase-major.

    CUDA tensors go through the hand kernel (csrc/stream_extract.cu),
    launched on the current stream without a synchronise; CPU tensors
    through ``stream_extract_torch``.  ``stream_extract.launches`` counts
    kernel launches.
    """
    _check_layout(layout, w1, w2)
    arrays = [w0, vm] + ([w1, w2] if layout == "stream3" else [])
    _check_inputs(arrays, k)
    if w0.device.type == "cpu":
        return stream_extract_torch(w0, w1, w2, vm, k, layout)
    if w0.device.type != "cuda":
        raise ValueError(f"unsupported device {w0.device}")
    if not all(a.is_contiguous() for a in arrays):
        raise ValueError("stream_extract needs contiguous inputs")
    out = torch.empty((16,) + tuple(w0.shape), dtype=torch.int64,
                      device=w0.device)
    s3 = layout == "stream3"
    with torch.cuda.device(w0.device):
        err = _launcher()(
            w0.data_ptr(), w1.data_ptr() if s3 else None,
            w2.data_ptr() if s3 else None, vm.data_ptr(), w0.numel(), k,
            int(s3), out.data_ptr(),
            torch.cuda.current_stream(w0.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stream_extract kernel launch failed: CUDA "
                           f"error {err}")
    stream_extract.launches += 1
    return out


stream_extract.launches = 0

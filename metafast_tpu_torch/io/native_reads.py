"""Native-backed read parsing: whole-file parse -> padded device batches.

The port's copy of metafast_tpu/io/native_reads.py.  Uses the port's C++
parser (native/fastparse.cpp), which raises when it cannot be built
where the JAX package's returns None.  Decompression (.gz/.bz2) goes
through Python's C-backed zlib/bz2 modules.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..native import load_library
from . import reads as pyreads


def parse_file(path: str) -> tuple[np.ndarray, np.ndarray, int] | None:
    """(codes_concat uint8, lengths int32, n_skipped), or None for a
    format the native parser does not read (BINQ)."""
    lib = load_library()
    import bz2 as _bz2
    import gzip as _gzip
    fmt, comp = pyreads.detect_format(path)
    if fmt not in ("fasta", "fastq"):
        return None     # binq etc: python fallback
    if comp == "gz":
        raw = _gzip.open(path, "rb").read()
    elif comp == "bz2":
        raw = _bz2.open(path, "rb").read()
    else:
        raw = open(path, "rb").read()
    text = np.frombuffer(raw, dtype=np.uint8)
    n = len(text)
    global PARSED_BYTES
    PARSED_BYTES += n
    codes = np.empty(n, dtype=np.uint8)
    max_reads = n // 2 + 16
    lengths = np.empty(max_reads, dtype=np.int32)
    skipped = ctypes.c_int64(0)
    consumed = ctypes.c_int64(0)

    tp = text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    cp = codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lp = lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    if fmt == "fasta":
        n_reads = lib.parse_fasta(tp, n, cp, n, lp, max_reads,
                                  ctypes.byref(skipped),
                                  ctypes.byref(consumed))
    else:
        offset = pyreads._detect_quality_format(path)
        n_reads = lib.parse_fastq(tp, n, offset, cp, n, lp, max_reads,
                                  ctypes.byref(skipped),
                                  ctypes.byref(consumed))
    lengths = lengths[:n_reads].copy()
    codes = codes[: int(lengths.sum())].copy()
    return codes, lengths, int(skipped.value)


# bytes parsed by this process via parse_file/parse_file_range since
# import — instrumentation for the per-host partitioning tests
PARSED_BYTES = 0


def record_boundary(path: str, pos: int) -> int | None:
    """Snap a byte offset FORWARD to the next record start (>= pos).

    The multi-host analog of the reference's record-aligned byte ranges
    (src/io/BytesDispatcher.java:39-67): every process applies this same
    deterministic snap to its range endpoints, so ranges partition the
    file exactly.  Uncompressed FASTA/FASTQ only; returns None when the
    format cannot be range-split (caller falls back to a full parse).
    """
    import os

    fmt, comp = pyreads.detect_format(path)
    if comp or fmt not in ("fasta", "fastq"):
        return None
    size = os.path.getsize(path)
    if pos <= 0:
        return 0
    if pos >= size:
        return size
    with open(path, "rb") as fh:
        fh.seek(max(pos - 1, 0))
        if fmt == "fasta":
            # record start = '>' at a line start
            window = 1 << 16
            off = max(pos - 1, 0)
            tail = b""
            while off < size:
                buf = tail + fh.read(window)
                hit = buf.find(b"\n>")
                if hit >= 0:
                    return off - len(tail) + hit + 1
                tail = buf[-1:]
                off += window
            return size
        # FASTQ: 4-line records; a line L is a record start iff it begins
        # with '@', line L+2 begins with '+', and len(seq) == len(qual)
        # (the standard disambiguation — '@' may open quality lines)
        window = 1 << 16
        for attempt in range(4):
            fh.seek(max(pos - 1, 0))
            buf = fh.read(window << attempt)
            starts = [i + 1 for i, ch in enumerate(buf[:-1])
                      if ch == 0x0A]
            for si in range(len(starts) - 4):
                a, b, c, d, e = starts[si:si + 5]
                if (buf[a:a + 1] == b"@" and buf[c:c + 1] == b"+"
                        and (c - b) == (e - d)):
                    return max(pos - 1, 0) + a
            if max(pos - 1, 0) + len(buf) >= size:
                return size
        return None


def parse_file_range(path: str, start: int, end: int
                     ) -> tuple[np.ndarray, np.ndarray, int] | None:
    """parse_file restricted to the record-aligned byte range that the
    deterministic snap maps [start, end) onto.  None = not range-splittable
    (compressed / unusual format)."""
    global PARSED_BYTES
    lib = load_library()
    beg = record_boundary(path, start)
    if beg is None:
        return None
    fin = record_boundary(path, end)
    if fin is None or fin < beg:
        return None
    if fin == beg:
        return (np.zeros(0, np.uint8), np.zeros(0, np.int32), 0)
    fmt, _comp = pyreads.detect_format(path)
    with open(path, "rb") as fh:
        fh.seek(beg)
        raw = fh.read(fin - beg)
    text = np.frombuffer(raw, dtype=np.uint8)
    n = len(text)
    PARSED_BYTES += n
    codes = np.empty(n, dtype=np.uint8)
    max_reads = n // 2 + 16
    lengths = np.empty(max_reads, dtype=np.int32)
    skipped = ctypes.c_int64(0)
    consumed = ctypes.c_int64(0)
    tp = text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    cp = codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lp = lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    if fmt == "fasta":
        n_reads = lib.parse_fasta(tp, n, cp, n, lp, max_reads,
                                  ctypes.byref(skipped),
                                  ctypes.byref(consumed))
    else:
        offset = pyreads._detect_quality_format(path)
        n_reads = lib.parse_fastq(tp, n, offset, cp, n, lp, max_reads,
                                  ctypes.byref(skipped),
                                  ctypes.byref(consumed))
    lengths = lengths[:n_reads].copy()
    codes = codes[: int(lengths.sum())].copy()
    return codes, lengths, int(skipped.value)


def to_batches(codes: np.ndarray, lengths: np.ndarray, batch_reads: int,
               pad_to: int = 128):
    """Yield (padded [B, L] uint8, lengths int32) batches from a
    concatenated code stream."""
    offsets = np.r_[0, np.cumsum(lengths.astype(np.int64))]
    n = len(lengths)
    # full batches use a fixed row count; the tail (or a small file) is
    # bucketed to {2^k, 3*2^(k-1)} rows, so kernel signatures stay a
    # bounded set while small inputs don't pay for batch_reads rows
    for s in range(0, n, batch_reads):
        e = min(s + batch_reads, n)
        rows = batch_reads if e - s == batch_reads else _bucket_rows(e - s)
        ls = np.zeros(rows, dtype=np.int32)
        ls[: e - s] = lengths[s:e]
        maxlen = int(ls.max()) if e > s else 0
        L = _bucket_len(maxlen, pad_to)
        out = np.zeros((rows, L), dtype=np.uint8)
        mask = np.arange(L)[None, :] < ls[:, None]
        out[mask] = codes[offsets[s]:offsets[e]]
        yield out, ls


def _bucket_rows(n: int) -> int:
    r = 16
    while r < n:
        r *= 2
    if n <= 3 * (r // 4):
        return 3 * (r // 4)
    return r


def _bucket_len(maxlen: int, pad_to: int = 128) -> int:
    """Pad row length into the {2^k, 3*2^(k-1)} bucket family (>= pad_to):
    variable-length inputs (contigs) would otherwise mint a fresh kernel
    signature — and a minutes-long TPU compile — per 128-multiple."""
    L = pad_to
    while L < maxlen:
        L *= 2
    if maxlen <= 3 * (L // 4) and 3 * (L // 4) >= pad_to:
        return 3 * (L // 4)
    return L


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """[B, L] codes (L % 4 == 0) -> [B, L//4] packed bytes."""
    B, L = codes.shape
    c = codes.reshape(B, L // 4, 4).astype(np.uint16)
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6)).astype(np.uint8)


def to_packed_batches(codes: np.ndarray, lengths: np.ndarray,
                      batch_reads: int, pad_to: int = 128):
    """Like to_batches but yields ([B, L//4] packed, lengths, L).

    Uses the single-pass C++ packer (the NumPy pad-then-pack costs ~1s
    per 100M bases on the counting hot path).
    """
    lib = load_library()
    offsets = np.r_[0, np.cumsum(lengths.astype(np.int64))]
    n = len(lengths)
    for s in range(0, n, batch_reads):
        e = min(s + batch_reads, n)
        rows = batch_reads if e - s == batch_reads else _bucket_rows(e - s)
        ls = np.zeros(rows, dtype=np.int32)
        ls[: e - s] = lengths[s:e]
        maxlen = int(lengths[s:e].max()) if e > s else 0
        L = _bucket_len(maxlen, pad_to)
        out = np.empty((rows, L // 4), dtype=np.uint8)
        off = np.ascontiguousarray(offsets[s:e + 1] - offsets[s])
        lib.pack_batch(
            codes[offsets[s]:offsets[e]].ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)),
            off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            e - s, L,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), rows)
        yield out, ls, L

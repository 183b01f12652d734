"""Bounds of the hand kernels from their shapes: the bytes each must move
once, over the card's published memory rate.

K1 (``csrc/stream_extract.cu``) reads, per 32-bit word of the read
stream, the word itself, the validity mask word and in the "stream3"
layout the next two words of the same read (w1, w2), and writes 16
int64 keys.  Each input byte is counted as read once and each output
byte as written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12   # NVIDIA H100 SXM, published (data sheet)
K1_KERNEL = "stream_extract_kernel"


def k1_bytes(n_words: int, layout: str = "stream3") -> int:
    inputs = 4 if layout == "stream3" else 2     # u32 arrays read
    return n_words * (4 * inputs + 16 * 8)


def bound_s(n_bytes: int) -> float:
    """Least seconds to move ``n_bytes`` at the card's memory rate."""
    return n_bytes / HBM_BYTES_PER_S

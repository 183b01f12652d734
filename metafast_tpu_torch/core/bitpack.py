"""2-bit DNA k-mer arithmetic on int64 keys.

A k-mer (k <= 31) is the 2k-bit integer of its codes, first nucleotide
most significant, held in an int64 tensor.  Such keys stay below 2**62,
so they are non-negative and ascending int64 order equals the JAX
package's (hi, lo) uint32 pair order.  INT64_MAX is the "no k-mer"
sentinel: it sorts after every key, as the JAX all-ones pair does.

Encoding parity with the reference toolkit (ctlab/metafast), as in
metafast_tpu/core/bitpack.py:
  A=0, G=1, C=2, T=3; complement(x) = 3 - x
  reverse complement = complement + reversal of the 2-bit groups
  canonical key = min(fw, rc)

torch's >> on int64 is arithmetic; every right shift of a value that may
have its sign bit set is masked afterwards.
"""

from __future__ import annotations

import torch

#: "no k-mer": sorts after every valid key (valid keys are < 2**62)
SENTINEL = (1 << 63) - 1


def kmer_mask(k: int) -> int:
    """Mask of the 2k bits of a k-mer value."""
    return (1 << (2 * k)) - 1


def _rev2_64(x: torch.Tensor) -> torch.Tensor:
    """Reverse the thirty-two 2-bit groups of each int64."""
    for s, m in ((2, 0x3333333333333333), (4, 0x0F0F0F0F0F0F0F0F),
                 (8, 0x00FF00FF00FF00FF), (16, 0x0000FFFF0000FFFF),
                 (32, 0x00000000FFFFFFFF)):
        x = ((x & m) << s) | ((x >> s) & m)
    return x


def rc(v: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of each k-mer value."""
    comp = v ^ kmer_mask(k)
    return (_rev2_64(comp) >> (64 - 2 * k)) & kmer_mask(k)


def canonical(v: torch.Tensor, k: int) -> torch.Tensor:
    """min(fw, rc) canonical form of each k-mer value."""
    return torch.minimum(v, rc(v, k))


def shift_right(v: torch.Tensor, nuc, k: int) -> torch.Tensor:
    """Append nucleotide at the right end: ((V << 2) | nuc) & mask(2k)."""
    return ((v << 2) | nuc) & kmer_mask(k)


def shift_left(v: torch.Tensor, nuc, k: int) -> torch.Tensor:
    """Prepend nucleotide at the left end: (V >> 2) | (nuc << (2k-2))."""
    return (v >> 2) | (torch.as_tensor(nuc, dtype=torch.int64,
                                       device=v.device) << (2 * k - 2))


def first_nuc(v: torch.Tensor, k: int) -> torch.Tensor:
    """Leftmost nucleotide code: V >> (2k-2)."""
    return (v >> (2 * k - 2)) & 3


def last_nuc(v: torch.Tensor) -> torch.Tensor:
    """Rightmost nucleotide code."""
    return v & 3


def is_sentinel(v: torch.Tensor) -> torch.Tensor:
    return v == SENTINEL


def complement_nuc(nuc):
    """complement(x) = 3 - x."""
    return 3 - nuc

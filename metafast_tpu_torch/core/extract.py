"""Batched canonical k-mer extraction from padded read batches.

Counterpart of metafast_tpu/core/extract.py.  Input: a padded batch of
reads as nucleotide codes ``codes[B, L]`` (A=0, G=1, C=2, T=3; padding
arbitrary) plus per-read lengths.  Output: the canonical int64 key of every
window position, SENTINEL where the window runs past the read's end, and
the validity mask, in place of the JAX package's (hi, lo, valid).  Plain
torch ops: the JAX package computes this in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from .bitpack import SENTINEL


def extract_canonical(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical k-mers of every window of every read in a batch.

    codes: [B, L] integer codes (0..3), padded; lengths: [B] valid read
    lengths; k in 1..31.  Returns (keys [B, P] int64, valid [B, P] bool)
    with P = L - k + 1 and keys = SENTINEL where valid is False.
    """
    if not 1 <= k <= 31:
        raise ValueError(f"k must be in [1, 31], got {k}")
    B, L = codes.shape
    if k > L:
        raise ValueError(f"k={k} larger than padded read length {L}")
    P = L - k + 1
    c = codes.to(torch.int64)
    fw = torch.zeros((B, P), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fw)
    for t in range(k):
        ct = c[:, t:t + P]
        # forward: code t at bit offset 2(k-1-t); reverse complement: the
        # complemented code t at bit offset 2t
        fw |= ct << (2 * (k - 1 - t))
        rc |= (3 - ct) << (2 * t)
    pos = torch.arange(P, device=codes.device)
    valid = pos[None, :] + k <= lengths.to(codes.device)[:, None]
    keys = torch.where(valid, torch.minimum(fw, rc), SENTINEL)
    return keys, valid


def unpack_2bit(packed: torch.Tensor, L: int) -> torch.Tensor:
    """[B, L//4] packed bytes (4 codes each, first code in the low bits)
    -> [B, L] uint8 codes."""
    p = packed.to(torch.uint8)
    codes = torch.stack([(p >> (2 * j)) & 3 for j in range(4)], dim=-1)
    return codes.reshape(p.shape[0], -1)[:, :L]


def extract_canonical_packed(packed: torch.Tensor, lengths: torch.Tensor,
                             k: int, L: int):
    """extract_canonical over 2-bit packed input (4 codes a byte)."""
    return extract_canonical(unpack_2bit(packed, L), lengths, k)

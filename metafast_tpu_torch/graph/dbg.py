"""De Bruijn graph neighbor/extension tables over a sorted k-mer table.

Counterpart of metafast_tpu/graph/dbg.py (:33-126).  For every canonical
key (in its forward orientation) the 4 left and 4 right neighbor
candidates are looked up in the table, giving the unique-extension codes

    ext = -1 (no present neighbor) / -2 (fork) / 0..3 (the unique nucleotide)

as HashMapOperations.getLeft/RightNucleotide
(src/algo/HashMapOperations.java:13-47), for all k-mers at once.
"""

from __future__ import annotations

import torch

from ..core import bitpack as bp
from . import lookup

NONE = -1
FORK = -2


def neighbor_tables(keys: torch.Tensor, k: int):
    """All neighbor data for a sorted canonical int64 key table [M].

    Returns {"left": ..., "right": ...}, each a dict of [4, M] tensors
    indexed by the added nucleotide:
      val      oriented neighbor value (forward frame)
      idx      table index of its canonical key (int64, clipped)
      present  bool
      is_fw    the oriented value is its own canonical key
    and ext [M] int64, the unique-extension code of that side.
    """
    sent = bp.is_sentinel(keys)
    nuc = torch.arange(4, dtype=torch.int64, device=keys.device)[:, None]
    res = {}
    for side, shift in (("left", bp.shift_left), ("right", bp.shift_right)):
        val = shift(keys[None, :], nuc, k)
        can = torch.where(sent[None, :], bp.SENTINEL, bp.canonical(val, k))
        idx, present = lookup.find(keys, can)
        present &= ~sent[None, :]
        deg = present.sum(0)
        # argmax returns the first maximal index; it takes no bool
        uniq = torch.argmax(present.to(torch.int8), dim=0)
        ext = torch.where(deg == 0, NONE, torch.where(deg >= 2, FORK, uniq))
        res[side] = dict(val=val, idx=idx, present=present,
                         is_fw=val == can, ext=ext)
    return res


def ext_map_rc(ext: torch.Tensor) -> torch.Tensor:
    """Extension code seen from the reverse-complement orientation:
    -1/-2 unchanged, a unique nucleotide m becomes 3 - m."""
    return torch.where(ext >= 0, 3 - ext, ext)

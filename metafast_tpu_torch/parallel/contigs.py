"""Sharded contig chain ranking: pointer doubling over row blocks.

Counterpart of metafast_tpu/parallel/contigs.py.  Rank r holds the row
block [r*b, (r+1)*b) of the oriented-node state (b = ceil(n / ranks); the
last block is shorter) and runs Wyllie doubling with one routed lookup
per round: each rank sends every pointer target to the rank that owns it,
the owner answers with its (ptr, dist) rows, and the answers come back
(``distributed.exchange`` / ``reply``: two uneven all-to-alls).  An
all_reduce(MAX) of a per-rank "moved" flag ends the rounds.

The JAX version sizes its request buffers at the worst case, [d, m] per
peer (:19-22, :58-60); the exact splits here move only the requests
there are, so there is no cap and no multi-round exchange.
"""

from __future__ import annotations

import numpy as np
import torch

from . import distributed as D
from .distributed import Mesh


def _route_gather(mesh: Mesh, state: torch.Tensor, idx: torch.Tensor,
                  b: int) -> torch.Tensor:
    """state[idx] for GLOBAL node ids ``idx``, where ``state`` ([rows, c])
    is this rank's row block: requests out, answers back."""
    (req,), plan = D.exchange(mesh, idx // b, idx)
    (ans,) = D.reply(plan, state[req - mesh.rank * b])
    return ans


def sharded_doubling(succ, mesh: Mesh):
    """(term, dist, reached) of a successor forest (succ -1 = none),
    every node's terminal, steps to it and whether its chain ends; equal
    to graph.contigs._doubling on every node, on every rank, on the
    mesh's device.  Every rank passes the same ``succ``."""
    succ = torch.as_tensor(succ).to(mesh.device, torch.int64)
    n = succ.numel()
    b = max(1, -(-n // mesh.size))
    lo, hi = min(mesh.rank * b, n), min((mesh.rank + 1) * b, n)
    mine = succ[lo:hi]
    terminal = mine < 0
    nodes = torch.arange(lo, hi, dtype=torch.int64, device=mesh.device)
    ptr = torch.where(terminal, nodes, mine)
    dist = (~terminal).to(torch.int64)
    # the round cap of _doubling: cycles never settle
    rounds = max(1, int(np.ceil(np.log2(max(2, n)))) + 1)
    for _ in range(rounds):
        got = _route_gather(mesh, torch.stack([ptr, dist], 1), ptr, b)
        moved = bool((got[:, 0] != ptr).any())
        ptr, dist = got[:, 0], dist + got[:, 1]
        if not D.all_reduce(mesh, int(moved), "max"):
            break
    reached = _route_gather(mesh, terminal.to(torch.int64)[:, None], ptr,
                            b)[:, 0]
    return (D.all_gather_cat(mesh, ptr), D.all_gather_cat(mesh, dist),
            D.all_gather_cat(mesh, reached) != 0)

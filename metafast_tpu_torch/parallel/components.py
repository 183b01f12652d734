"""Sharded connected components: large-star / small-star contraction.

Counterpart of metafast_tpu/parallel/components.py.  Edges are sharded by
a hash of their source vertex, so each rank holds O(E / ranks) edge pairs
and no [M] label vector exists until the final relabel.  The rounds are
the star contraction of graph/components.py (``_star_contract`` over the
rewrite ``_star_emit``), whose single-device twin is
``star_connected_labels``: here each rank rewrites its sources' runs of
edges and sends every rewritten edge, in both orientations, to the rank
of its new source with one uneven all-to-all, deduplicating there, where
the single-device twin deduplicates locally.  The rounds converge to a
forest of stars (child -> component minimum), which is the label
assignment.

An edge (u, v) is held as one int64, u << 32 | v (vertex ids < 2^31), so
sorting the int64s sorts the pairs by (u, v).

Where it departs from the JAX package: the fixed point is tested
exactly.  JAX stops when a psum of (edge count, 32-bit checksum) repeats
(:170-182, :284); here every rank compares its deduplicated edge list
with the one it held after the previous small-star round, and one
all_reduce(MAX) of the "changed" flags ends the rounds.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..graph.components import _active_edges, _star_contract, _star_labels
from ..utils.hash32 import mul32
from . import distributed as D
from .distributed import Mesh


def _hash_vert(u: torch.Tensor) -> torch.Tensor:
    """metafast_tpu/parallel/components.py _hash_vert (:212) on vertex
    ids below 2^32, in int64 arithmetic."""
    h = mul32(u, 0x9E3779B9)
    h ^= h >> 16
    h = mul32(h, 0x85EBCA6B)
    return h ^ (h >> 13)


def _exchange_edges(mesh: Mesh, u: torch.Tensor, v: torch.Tensor):
    """Both orientations of the edges (u, v) at the ranks of their
    sources, deduplicated and sorted."""
    su, sv = torch.cat([u, v]), torch.cat([v, u])
    (got,), _ = D.exchange(mesh, _hash_vert(su) % mesh.size, su << 32 | sv)
    return torch.unique(got)


def sharded_connected_labels(nbr, active, mesh: Mesh) -> torch.Tensor:
    """Min label per vertex over the active subgraph; inactive rows get M.

    The sharded twin of graph.components.star_connected_labels, equal to
    it and to every labeller of that module.  nbr: [8, M] neighbor
    indices (-1 absent), active: [M] bool; every rank passes the same
    inputs (tensors or numpy) and gets the labels, int64 on the mesh's
    device.
    """
    dev = mesh.device
    nbr = torch.as_tensor(nbr).to(dev, torch.int64)
    active = torch.as_tensor(active).to(dev, torch.bool)
    src, dst = _active_edges(nbr, active)
    # this rank's sources, as the JAX host setup deals them (:396-408)
    mine = _hash_vert(src) % mesh.size == mesh.rank
    edges = torch.unique(src[mine] << 32 | dst[mine])
    star = _star_contract(
        edges, nbr.shape[1], lambda u, v: _exchange_edges(mesh, u, v),
        lambda changed: bool(D.all_reduce(mesh, int(changed), "max")))
    labels = _star_labels(star, active)
    dist.all_reduce(labels, dist.ReduceOp.MIN)
    return labels

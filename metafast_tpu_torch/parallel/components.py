"""Sharded connected components: large-star / small-star contraction.

Counterpart of metafast_tpu/parallel/components.py.  Edges are sharded by
a hash of their source vertex, so each rank holds O(E / ranks) edge pairs
and no [M] label vector exists until the final relabel.  Each round
applies the LARGE-STAR or SMALL-STAR rewrite (Kiveris et al., "Connected
Components in MapReduce and Beyond", SoCC 2014) to every source's run of
edges, then sends each rewritten edge, in both orientations, to the rank
of its new source with one uneven all-to-all and deduplicates there.  The
rounds converge to a forest of stars (child -> component minimum), which
is the label assignment.

An edge (u, v) is held as one int64, u << 32 | v (vertex ids < 2^31), so
sorting the int64s sorts the pairs by (u, v).

Where it departs from the JAX package: the fixed point is tested
exactly.  JAX stops when a psum of (edge count, 32-bit checksum) repeats
(:170-182, :284); here every rank compares its deduplicated edge list
with the one it held after the previous small-star round, and one
all_reduce(MAX) of the "changed" flags ends the rounds.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from . import distributed as D
from .count import _M32, _mul32
from .distributed import Mesh


def _hash_vert(u: torch.Tensor) -> torch.Tensor:
    """metafast_tpu/parallel/components.py _hash_vert (:212) on vertex
    ids below 2^32, in int64 arithmetic."""
    h = _mul32(u, 0x9E3779B9)
    h ^= h >> 16
    h = _mul32(h, 0x85EBCA6B)
    return h ^ (h >> 13)


def _star_emit(edges: torch.Tensor, large: bool):
    """One rank's star rewrite (metafast_tpu/parallel/components.py
    :234-258) over its sorted edges: per source run, m = min(u, first v);
    emit (v, m) for the large (v > u) or small (v < u) side, plus (u, m)
    at run starts for small-star.  Returns (new u, new v)."""
    u, v = edges >> 32, edges & _M32
    start = torch.ones_like(u, dtype=torch.bool)
    start[1:] = u[1:] != u[:-1]
    run = torch.cumsum(start.to(torch.int64), 0) - 1
    m = torch.minimum(u, v[start][run])
    side = (v > u) if large else (v < u)
    emit = side & (v != m)
    nu, nv = v[emit], m[emit]
    if large:
        return nu, nv
    emit = start & (m != u)
    return torch.cat([nu, u[emit]]), torch.cat([nv, m[emit]])


def _exchange_edges(mesh: Mesh, u: torch.Tensor, v: torch.Tensor):
    """Both orientations of the edges (u, v) at the ranks of their
    sources, deduplicated and sorted."""
    su, sv = torch.cat([u, v]), torch.cat([v, u])
    (got,), _ = D.exchange(mesh, _hash_vert(su) % mesh.size, su << 32 | sv)
    return torch.unique(got)


def sharded_connected_labels(nbr, active, mesh: Mesh) -> torch.Tensor:
    """Min label per vertex over the active subgraph; inactive rows get M.

    Equal to graph.components.connected_labels.  nbr: [8, M] neighbor
    indices (-1 absent), active: [M] bool; every rank passes the same
    inputs (tensors or numpy) and gets the labels, int64 on the mesh's
    device.
    """
    dev = mesh.device
    nbr = torch.as_tensor(nbr).to(dev, torch.int64)
    active = torch.as_tensor(active).to(dev, torch.bool)
    M = nbr.shape[1]
    src = torch.arange(M, dtype=torch.int64, device=dev).repeat(
        nbr.shape[0])
    dst = nbr.reshape(-1)
    keep = (dst >= 0) & (src != dst)
    keep &= active[src] & active[dst.clamp(0, max(M - 1, 0))]
    src, dst = src[keep], dst[keep]
    # this rank's sources, as the JAX host setup deals them (:396-408)
    mine = _hash_vert(src) % mesh.size == mesh.rank
    edges = torch.unique(src[mine] << 32 | dst[mine])

    prev = None
    max_rounds = 4 * (int(np.ceil(np.log2(max(M, 2)))) + 2) ** 2 + 8
    for rnd in range(max_rounds):
        large = rnd % 2 == 0
        edges = _exchange_edges(mesh, *_star_emit(edges, large))
        if large:
            continue
        changed = prev is None or not torch.equal(edges, prev)
        if not D.all_reduce(mesh, int(changed), "max"):
            break
        prev = edges
    else:
        raise RuntimeError("star contraction did not converge")

    # labels from the star forest: each source's least neighbour
    labels = torch.where(active, torch.arange(M, device=dev), M)
    labels.scatter_reduce_(0, edges >> 32, edges & _M32, "amin")
    dist.all_reduce(labels, dist.ReduceOp.MIN)
    return labels

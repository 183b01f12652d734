"""Connected components with size-window splitting — label propagation.

Counterpart of metafast_tpu/graph/components.py (:38-180, :558-688).
Reference semantics (src/algo/ComponentsBuilder.java): at threshold t the
graph over surviving k-mers is partitioned into connected components;
components smaller than b1 are dropped, those within [b1, b2] are emitted
with weight = sum of counts and usedFreqThreshold = t, and oversized ones
are re-processed at t+1 restricted to k-mers with count >= t+1.

Components come from min-label propagation with hooking
(Shiloach-Vishkin style) on the device: each round pushes labels along
every edge with a scatter-min, hooks each vertex's new minimum onto its
old root, and compresses twice, until a round changes nothing.

Emitted components are sorted by (usedFreqThreshold asc, weight desc,
size desc, smallest member key), as ConnectedComponent.compareTo with a
deterministic tie order.  The JAX package's walk/star-contraction label
paths are not ported: its pipeline never reaches them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import dbg


@dataclass
class Component:
    kmers: torch.Tensor        # sorted int64 canonical keys, on the device
    weight: int
    used_freq_threshold: int

    @property
    def size(self) -> int:
        return self.kmers.numel()


def adjacency(keys: torch.Tensor, k: int) -> torch.Tensor:
    """[8, M] neighbor table indices (-1 = absent): left then right.

    Parity: KmerOperations.possibleNeighbours
    (src/algo/KmerOperations.java:9-27).
    """
    t = dbg.neighbor_tables(keys, k)
    idx = torch.cat([t["left"]["idx"], t["right"]["idx"]])
    present = torch.cat([t["left"]["present"], t["right"]["present"]])
    return torch.where(present, idx, -1)


def _scatter_min(base: torch.Tensor, index: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """base.at[index].min(src) with index len(base) dropped."""
    buf = torch.cat([base, base.new_full((1,), base.numel())])
    buf.scatter_reduce_(0, index, src, "amin")
    return buf[:-1]


def _label_round(labels: torch.Tensor, nbr: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """One hooking round (metafast_tpu/graph/components.py:70-105)."""
    M = labels.numel()
    old = torch.where(active, labels, M)
    # push: relax every edge from an active vertex with one scatter-min
    tgt = torch.where((nbr >= 0) & active[None, :], nbr.clamp(0, M - 1), M)
    labels = _scatter_min(old, tgt.reshape(-1),
                          old.expand_as(tgt).reshape(-1))
    # hook: each vertex's pushed minimum onto its old root
    labels = _scatter_min(labels, old, labels)
    # compress: two hops
    for _ in range(2):
        labels = torch.minimum(labels, labels[labels.clamp(0, M - 1)])
    return torch.where(active, labels, M)


def connected_labels(nbr: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Min-label per vertex over the active subgraph; inactive rows get M.

    Runs hooking rounds to the fixed point."""
    M = nbr.shape[1]
    ids = torch.arange(M, dtype=torch.int64, device=nbr.device)
    prev = torch.where(active, ids, M)
    cur = _label_round(prev, nbr, active)
    while not torch.equal(prev, cur):
        prev, cur = cur, _label_round(cur, nbr, active)
    return cur


def split_components(keys: torch.Tensor, counts: torch.Tensor, k: int,
                     b1: int, b2: int) -> list[Component]:
    """Size-window component splitting over a counted k-mer table.

    keys: [M] sorted canonical int64 keys; counts: [M] int32, on one
    device.  Labels are computed on the device; the per-level bookkeeping
    runs on the host.
    """
    device = keys.device
    keys64 = keys.cpu().numpy()
    counts_all = counts.cpu().numpy().astype(np.int64)
    M = len(keys64)
    if M == 0:
        return []
    active = np.ones(M, dtype=bool)
    nbr = None
    thr = 1
    found = []      # (member keys, weight, threshold)
    while active.any():
        # below 1/4 occupancy, continue on the compacted sub-table: the
        # label rounds cost O(table size), and membership is by key value,
        # so compaction cannot change a component
        n_act = int(active.sum())
        if n_act * 4 <= M and M > 16:
            sel = np.nonzero(active)[0]
            keys64, counts_all = keys64[sel], counts_all[sel]
            M = len(keys64)
            active = np.ones(M, dtype=bool)
            nbr = None
        if nbr is None:
            nbr = adjacency(torch.from_numpy(keys64).to(device), k)
        labels = connected_labels(
            nbr, torch.from_numpy(active).to(device)).cpu().numpy()
        act_idx = np.nonzero(active)[0]
        roots = labels[act_idx]
        order = np.argsort(roots, kind="stable")
        act_sorted = act_idx[order]
        roots_sorted = roots[order]
        starts = np.nonzero(np.r_[True, roots_sorted[1:]
                                  != roots_sorted[:-1]])[0]
        ends = np.r_[starts[1:], len(roots_sorted)]
        sizes = ends - starts

        next_active = np.zeros(M, dtype=bool)
        for s, e in zip(starts[sizes >= b1], ends[sizes >= b1]):
            # act_idx ascends and the sort is stable: members ascend, so
            # their keys are sorted
            members = act_sorted[s:e]
            if e - s <= b2:
                found.append((keys64[members],
                              int(counts_all[members].sum()), thr))
            else:
                next_active[members[counts_all[members] >= thr + 1]] = True
        active = next_active
        thr += 1
        if thr > 32768:
            break

    found.sort(key=lambda c: (c[2], -c[1], -len(c[0]), int(c[0][0])))
    if not found:
        return []
    sizes = [len(c[0]) for c in found]
    kmers = torch.from_numpy(np.concatenate([c[0] for c in found])).to(device)
    return [Component(kmers=km, weight=w, used_freq_threshold=t)
            for km, (_, w, t) in zip(torch.split(kmers, sizes), found)]

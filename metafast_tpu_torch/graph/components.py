"""Connected components with size-window splitting.

Counterpart of metafast_tpu/graph/components.py.  Reference semantics
(src/algo/ComponentsBuilder.java): at threshold t the graph over
surviving k-mers is partitioned into connected components; components
smaller than b1 are dropped, those within [b1, b2] are emitted with
weight = sum of counts and usedFreqThreshold = t, and oversized ones are
re-processed at t+1 restricted to k-mers with count >= t+1.

Three labellers share one contract, the min index per active vertex and
M on inactive rows:
  - ``star_connected_labels``: large-star / small-star contraction
    (Kiveris et al., "Connected Components in MapReduce and Beyond", SoCC
    2014) over the deduplicated edge list.  The rewrite (``_star_emit``)
    and its round loop (``_star_contract``) are written once, here; the
    sharded twin (parallel/components.py) runs the same loop with an
    exchange between ranks in place of the local deduplication.
  - ``walk_connected_labels``: for a full-live table (every row active).
    The chains of the successor forest are ranked once (graph/rank.py)
    and each contracted to its terminal node; the star contraction then
    runs on that quotient graph, about one vertex a chain.
  - ``hooking_connected_labels``: min-label propagation with hooking
    (Shiloach-Vishkin style), kept for A/B measurement and as the
    equality oracle of the other two in tests.

``split_components`` picks the labeller per level from what the H100
measured (the constants below), never from the device type.  Emitted
components are sorted by (usedFreqThreshold asc, weight desc, size desc,
smallest member key), as ConnectedComponent.compareTo with a
deterministic tie order.

Where it departs from the JAX package: the star fixed point is tested
exactly, by comparing the deduplicated edge list with the one held after
the previous small-star round, where JAX compares a 32-bit checksum
(:277-280, :303-328).  Edges are int64 pairs ``u << 32 | v``; the sort
semijoin of JAX ``_edges_from_nbr`` (:203-235), which avoided a gather,
and the width buckets, which bounded compile counts, are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import bitpack as bp
from ..utils import trace
from ..utils.hash32 import M32
from . import contigs, dbg
from .rank import chain_rank

# Labeller routes, from chip_smoke.py phase "labels" on the S=8 stress
# data (NVIDIA H100 80GB HBM3, 700 W; two runs).  On every level, star
# beats hooking: the 12,990,882-key level-1 recount graph 0.183-0.196 s
# against 0.963-0.982 s, the ~10^6-key later levels 0.019-0.046 s
# against 0.060-0.095 s; so hooking is on no route.  On full-live tables
# the walk's lockstep rounds cost much the same at every size, where the
# star's edge rounds grow with it: walk against star 0.065-0.113 s /
# 0.183-0.196 s at 12,990,882 keys, 0.040-0.056 / 0.063-0.064 s at
# 3,997,670, 0.039-0.041 / 0.041-0.042 s at 2,498,224 (a tie), and
# 0.078 / 0.036 s at 999,958.  A full-live level of at least this many
# keys takes walk_connected_labels, the others star_connected_labels.
_WALK_MIN = 3 << 20


@dataclass
class Component:
    kmers: torch.Tensor        # sorted int64 canonical keys, on the device
    weight: int
    used_freq_threshold: int

    @property
    def size(self) -> int:
        return self.kmers.numel()


def _adjacency(tables: dict) -> torch.Tensor:
    """[8, M] neighbor indices (-1 = absent) from dbg.neighbor_tables."""
    L, R = tables["left"], tables["right"]
    idx = torch.cat([L["idx"], R["idx"]])
    present = torch.cat([L["present"], R["present"]])
    return torch.where(present, idx, -1)


def adjacency(keys: torch.Tensor, k: int) -> torch.Tensor:
    """[8, M] neighbor table indices (-1 = absent): left then right.

    Parity: KmerOperations.possibleNeighbours
    (src/algo/KmerOperations.java:9-27).
    """
    return _adjacency(dbg.neighbor_tables(keys, k))


# ---------------------------------------------------------------------------
# Star contraction: one rewrite, run locally and sharded.


def _active_edges(nbr: torch.Tensor, active: torch.Tensor):
    """(u, v) of every active-active entry of the [8, M] adjacency,
    self loops dropped."""
    M = nbr.shape[1]
    src = torch.arange(M, dtype=torch.int64, device=nbr.device).repeat(
        nbr.shape[0])
    dst = nbr.reshape(-1)
    keep = (dst >= 0) & (src != dst)
    keep &= active[src] & active[dst.clamp(0, max(M - 1, 0))]
    return src[keep], dst[keep]


def _star_emit(edges: torch.Tensor, large: bool):
    """The star rewrite (metafast_tpu/parallel/components.py :234-258)
    over sorted edges: per source run, m = min(u, first v); emit (v, m)
    for the large (v > u) or small (v < u) side, plus (u, m) at run starts
    for small-star.  Returns (new u, new v)."""
    u, v = edges >> 32, edges & M32
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


def _mirror_unique(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Both orientations of the edges (u, v) as sorted unique int64s."""
    return torch.unique(torch.cat([u << 32 | v, v << 32 | u]))


def _star_contract(edges: torch.Tensor, n_vertices: int,
                   exchange=_mirror_unique, any_changed=bool):
    """Large- and small-star rounds from ``edges`` (sorted, unique, both
    orientations) to the fixed point, a forest of stars (child -> its
    component's minimum, both orientations).

    ``exchange(u, v)`` turns a round's rewritten edges into the next
    round's edge list; ``any_changed(flag)`` says whether any holder's
    list changed since the previous small-star round (the sharded twin
    reduces the flag over its ranks).  Raises if the rounds do not
    converge."""
    prev = None
    max_rounds = 4 * (int(np.ceil(np.log2(max(n_vertices, 2)))) + 2) ** 2 + 8
    for rnd in range(max_rounds):
        large = rnd % 2 == 0
        edges = exchange(*_star_emit(edges, large))
        if large:
            continue
        changed = prev is None or not torch.equal(edges, prev)
        if not any_changed(changed):
            return edges
        prev = edges
    raise RuntimeError("star contraction did not converge")


def _star_labels(star: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Labels from a star forest: each vertex's least neighbour or
    itself; M on inactive rows."""
    M = active.numel()
    labels = torch.where(active, torch.arange(M, device=active.device), M)
    labels.scatter_reduce_(0, star >> 32, star & M32, "amin")
    return labels


def star_connected_labels(nbr: torch.Tensor,
                          active: torch.Tensor) -> torch.Tensor:
    """Min-label per vertex over the active subgraph (inactive rows get
    M) by star contraction on one device (JAX :334)."""
    M = nbr.shape[1]
    edges = _mirror_unique(*_active_edges(nbr, active))
    return _star_labels(_star_contract(edges, M), active)


# ---------------------------------------------------------------------------
# Chain walks: the star contraction on the chain quotient.


def walk_connected_labels(keys: torch.Tensor, k: int,
                          tables: dict | None = None) -> torch.Tensor:
    """Connected components of a full-live table via chain walks (JAX
    :350-508).

    The de Bruijn graph is almost all chains, and the successor function
    already encodes them: the chains are ranked once (graph/rank.py) and
    every node is represented by its chain's terminal node, or by its
    walk where the chain is a cycle.  The quotient edges are the
    orientation links fw(i) ~ rc(i), the links of every forked column to
    its neighbours, and the ring links of cycle walks; the star
    contraction labels that small graph.

    Precondition: every non-sentinel row of ``keys`` is active.  Returns
    the connected_labels contract: the min canonical index per key, M on
    sentinel rows.  ``tables`` is dbg.neighbor_tables(keys, k) if the
    caller has it.

    Parity: replaces the BFS of ComponentsBuilder.bfs
    (src/algo/ComponentsBuilder.java:220-269).
    """
    dev = keys.device
    M = keys.numel()
    n = 2 * M
    if tables is None:
        tables = dbg.neighbor_tables(keys, k)
    L, R = tables["left"], tables["right"]
    succ, _, _ = contigs._succ_from_tables(keys, L, R, k)
    valid = ~bp.is_sentinel(keys)
    valid2 = torch.cat([valid, valid])
    r = chain_rank(succ, valid2)
    walkid, term = r["walkid"], r["term"]
    # representative: the chain's terminal node, or n + walk id on cycles
    rep = torch.where(r["reached"], term,
                      torch.where(walkid >= 0, n + walkid, -1))
    rep_fw, rep_rc = rep[:M], rep[M:]

    # fork links: each forked column to each present neighbour (both
    # orientations of the neighbour share its orientation link)
    cols = torch.nonzero((L["ext"] == dbg.FORK)
                         | (R["ext"] == dbg.FORK)).flatten()
    nb = _adjacency(tables)[:, cols]
    fok = nb >= 0
    fu = rep_fw[cols].expand_as(nb)[fok]
    fv = rep_fw[nb[fok]]

    # ring links of cycle walks, where the stop node is a cycle node too
    res_stop, res_term = r["res_stop"], r["res_term"]
    Q = n + res_stop.numel()
    rep_stop = rep[res_stop.clamp(0, max(n - 1, 0))]
    cyc = (res_stop >= 0) & ~res_term & (rep_stop >= n)
    ring = n + torch.arange(res_stop.numel(), dtype=torch.int64, device=dev)

    u = torch.cat([rep_fw, fu, ring[cyc]])
    v = torch.cat([rep_rc, fv, rep_stop[cyc]])
    ok = (u >= 0) & (v >= 0) & (u != v)
    star = _star_contract(_mirror_unique(u[ok], v[ok]), Q)

    # per quotient vertex: its star root, then the least key it stands for
    qroot = _star_labels(star, torch.ones(Q, dtype=torch.bool, device=dev))
    canon = torch.arange(n, dtype=torch.int64, device=dev) % max(M, 1)
    sel = valid2 & (rep >= 0)
    m_rep = torch.full((Q,), M, dtype=torch.int64, device=dev)
    m_rep.scatter_reduce_(0, rep[sel], canon[sel], "amin")
    comp_min = torch.full((Q,), M, dtype=torch.int64, device=dev)
    comp_min.scatter_reduce_(0, qroot, m_rep, "amin")
    lab = comp_min[qroot[rep_fw.clamp(0, max(Q - 1, 0))]]
    return torch.where(valid & (rep_fw >= 0), lab, M)


# ---------------------------------------------------------------------------
# Hooking: the A/B and test oracle.


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


def hooking_connected_labels(nbr: torch.Tensor,
                             active: torch.Tensor) -> torch.Tensor:
    """Min-label per vertex over the active subgraph (inactive rows get
    M) by hooking rounds to the fixed point (JAX :534)."""
    M = nbr.shape[1]
    ids = torch.arange(M, dtype=torch.int64, device=nbr.device)
    prev = torch.where(active, ids, M)
    cur = _label_round(prev, nbr, active)
    while not torch.equal(prev, cur):
        prev, cur = cur, _label_round(cur, nbr, active)
    return cur


def connected_labels(nbr: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Min-label per vertex over the active subgraph; inactive rows get
    M.  The labeller of a level that is not full-live."""
    return star_connected_labels(nbr, active)


def _group(keys: torch.Tensor, counts: torch.Tensor, active: torch.Tensor,
           labels: torch.Tensor, thr: int, b1: int, b2: int):
    """One level's grouping by label, where the table lies.

    A row's group size is the number of active rows under its label.
    Groups within [b1, b2] are emitted: their rows, ascending, stably
    sorted by label, so each group's members ascend and its keys are
    sorted.  The rows of larger groups with count >= thr + 1 are the next
    level's.  Returns (the emitted member keys on the device, their
    groups' sizes, weights and first keys as a [3, G] host int64 array,
    the next level's active rows, their number)."""
    M = keys.numel()
    per_label = torch.zeros(M + 1, dtype=torch.int64, device=keys.device)
    per_label.scatter_add_(0, labels, active.to(torch.int64))
    size = torch.where(active, per_label[labels], 0)
    nxt = (size >= b1) & (size > b2) & (counts >= thr + 1)
    rows = torch.nonzero((size >= b1) & (size <= b2)).flatten()
    lab, order = torch.sort(labels[rows], stable=True)
    rows = rows[order]
    _, sizes = torch.unique_consecutive(lab, return_counts=True)
    ends = torch.cumsum(sizes, 0)
    csum = torch.cat([ends.new_zeros(1),
                      torch.cumsum(counts[rows], 0, dtype=torch.int64)])
    small = torch.stack([sizes, csum[ends] - csum[ends - sizes],
                         keys[rows[ends - sizes]]])
    trace.d2h(small)
    return keys[rows], small.cpu().numpy(), nxt, int(nxt.sum())


def split_components(keys: torch.Tensor, counts: torch.Tensor, k: int,
                     b1: int, b2: int) -> list[Component]:
    """Size-window component splitting over a counted k-mer table.

    keys: [M] sorted canonical int64 keys; counts: [M] int32, on one
    device.  Every level runs there: the labels, and the grouping by
    label (``_group``); the host reads a level's number of rows still
    active and its emitted groups' sizes, weights and first keys.  A
    level is full-live at the first level and after each compaction:
    large full-live levels take walk_connected_labels, the others
    connected_labels.  With a default mesh of more than one rank
    (api.set_default_mesh) every level takes the sharded star
    contraction (parallel/components.py), as the JAX package (:573-579).
    The returned components' kmers are views of their level's emitted
    keys, on the device.
    """
    from .. import api

    mesh = api.get_default_mesh()
    sharded = mesh is not None and mesh.size > 1
    if sharded:
        from ..parallel.components import sharded_connected_labels
    M = n_act = keys.numel()
    if M == 0:
        return []
    active = torch.ones(M, dtype=torch.bool, device=keys.device)
    tables = nbr = None
    full_live = True
    thr = 1
    levels = []     # (member keys on the device, [3, G] host array, thr)
    while n_act:
        with trace.span("components.level"):
            # below 1/4 occupancy, continue on the compacted sub-table:
            # the label rounds cost O(table size), and membership is by
            # key value, so compaction cannot change a component
            if n_act * 4 <= M and M > 16:
                with trace.span("components.bookkeeping"):
                    sel = torch.nonzero(active).flatten()
                    keys, counts = keys[sel], counts[sel]
                    M = n_act
                    active = torch.ones(M, dtype=torch.bool,
                                        device=keys.device)
                tables = nbr = None
                full_live = True
            with trace.span("components.labels"):
                if tables is None:
                    tables = dbg.neighbor_tables(keys, k)
                if full_live and not sharded and M >= _WALK_MIN:
                    labels = walk_connected_labels(keys, k, tables)
                else:
                    if nbr is None:
                        nbr = _adjacency(tables)
                    if sharded:
                        labels = sharded_connected_labels(nbr, active, mesh)
                    else:
                        labels = connected_labels(nbr, active)
            with trace.span("components.bookkeeping"):
                trace.count("components_grouped_keys", n_act)
                full_live = False
                members, small, active, n_act = _group(
                    keys, counts, active, labels, thr, b1, b2)
                if small.shape[1]:
                    levels.append((members, small, thr))
                thr += 1
        if thr > 32768:
            break

    if not levels:
        return []
    kmers = [km for m, s, _ in levels for km in torch.split(m, s[0].tolist())]
    size, weight, first = np.concatenate([s for _, s, _ in levels], axis=1)
    thrs = np.concatenate([np.full(s.shape[1], t) for _, s, t in levels])
    return [Component(kmers=kmers[i], weight=int(weight[i]),
                      used_freq_threshold=int(thrs[i]))
            for i in np.lexsort((first, -size, -weight, thrs))]


def members_to_host(comps: list[Component]) -> list[np.ndarray]:
    """Each component's member keys on the host, from one copy back of
    all of them."""
    if not comps:
        return []
    flat = torch.cat([c.kmers for c in comps])
    trace.d2h(flat)
    return np.split(flat.cpu().numpy(),
                    np.cumsum([c.size for c in comps])[:-1])

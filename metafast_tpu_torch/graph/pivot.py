"""Pivot-anchored component extraction.

Parity: src/algo/ComponentsBuilderAroundPivot.java (depth == 1) and
DeepComponentsBuilderAroundPivot.java (depth > 1): BFS from each
unprocessed pivot k-mer; unique continuations extend freely, forks are
entered only via a path probe that reaches another pivot (within `depth`
k-mers for the deep variant, choosing the pivot-richest path).

Determinism spec (the reference iterates hash maps, so its component
membership depends on hash layout; ours is fixed): pivots are processed
in ascending canonical-key order, fork branches in neighbor-nucleotide
order, and deep probes prefer the first-found best path.  Failed probe
paths stay consumed (marked visited) exactly like the reference's dfs
(ComponentsBuilderAroundPivot.java:360-428).

Deviations from reference bugs (documented, not replicated):
  - DeepComponentsBuilderAroundPivot.bfs adds a path k-mer's *pivot map
    value* to the component weight (:169-175) and bumps n_pivot once per
    path k-mer (:182); we add the graph value and bump once per path.

Scale envelope (MEASURED, tests/test_bfs_envelope.py): neighbor tables
are precomputed vectorized (one searchsorted over all 8 neighbor sets)
and materialized as Python lists; the traversal is queue-chasing Python
at ~5 us/node plus ~4 us/node of table build — a 2M-node chain
traverses in ~20 s.  That matches the tool's niche use (pivot sets are
statistically filtered k-mers, not whole samples).  The bulk pipeline
path (graph/components.py) is the device label-propagation instead.

Counterpart of metafast_tpu/graph/pivot.py (:1-445).  Where it departs:
  - ``_Graph`` builds its neighbor-index tables on the run's device
    (canonical neighbors + ``lookup.find``, a searchsorted) at any size;
    the JAX package routes by table size (``_DEVICE_MIN``) and by whether
    its backend is a TPU, and joins (hi, lo) uint32 pairs by sorting;
  - at depth 1 the native traversal's int32 tables are built on the
    run's device too (``depth1_index``: canonical neighbors and a
    last-of-run searchsorted, block by block into host tables; the
    colored traversal of ``graph/colored`` takes the same tables), where
    the JAX package builds them in a native hash on the host;
  - the native library is never missing in the port (a failed build
    raises), so the "no library" branch is gone; a members-buffer
    overflow of the native traversal still moves to the Python spec,
    with a warning.
"""

from __future__ import annotations

import ctypes
import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..core import bitpack as bp
from ..utils import trace
from ..utils.native import native_library
from .lookup import find

# a child of the launcher's logger, so warnings reach the run's log
_log = logging.getLogger("metafast_torch.graph")

_MASKS = [
    (0x3333333333333333, 0xCCCCCCCCCCCCCCCC, 2),
    (0x0F0F0F0F0F0F0F0F, 0xF0F0F0F0F0F0F0F0, 4),
    (0x00FF00FF00FF00FF, 0xFF00FF00FF00FF00, 8),
    (0x0000FFFF0000FFFF, 0xFFFF0000FFFF0000, 16),
    (0x00000000FFFFFFFF, 0xFFFFFFFF00000000, 32),
]


def rc_np(keys: np.ndarray, k: int) -> np.ndarray:
    """Vectorized reverse complement (KmerOperations.rc)."""
    x = np.asarray(keys, dtype=np.uint64)
    for lo, hi, s in _MASKS:
        x = ((x & np.uint64(lo)) << np.uint64(s)) \
            | ((x & np.uint64(hi)) >> np.uint64(s))
    x = ~x
    return (x >> np.uint64(64 - 2 * k)).astype(np.int64)


def canonical_np(keys: np.ndarray, k: int) -> np.ndarray:
    r = rc_np(keys, k)
    return np.minimum(np.asarray(keys, dtype=np.int64), r)


def right_neighbors_np(keys: np.ndarray, k: int) -> np.ndarray:
    """[N, 4] canonical right neighbors (KmerOperations.rightNeighbours)."""
    mask = np.uint64((1 << (2 * k)) - 1)
    base = (np.asarray(keys, dtype=np.uint64) << np.uint64(2)) & mask
    cols = [canonical_np((base | np.uint64(nuc)).astype(np.int64), k)
            for nuc in range(4)]
    return np.stack(cols, axis=1)


def left_neighbors_np(keys: np.ndarray, k: int) -> np.ndarray:
    """[N, 4] canonical left neighbors (KmerOperations.leftNeighbours)."""
    base = np.asarray(keys, dtype=np.uint64) >> np.uint64(2)
    cols = [canonical_np(
        (base | (np.uint64(nuc) << np.uint64(2 * (k - 1)))).astype(np.int64), k)
        for nuc in range(4)]
    return np.stack(cols, axis=1)


@dataclass
class PivotComponent:
    kmers: np.ndarray          # sorted int64 canonical keys
    weight: int
    n_pivot: int
    used_freq_threshold: int = 1

    @property
    def size(self) -> int:
        return len(self.kmers)


# list-materialization memory bound (~8 ints/key: two [N, 4] tables)
_LIST_MAX = 1 << 23


def neighbor_index(keys: torch.Tensor, k: int):
    """(right, left) [N, 4] int64 neighbor indices into a sorted int64 key
    table, -1 where the canonical neighbor is absent; column j holds the
    neighbor through nucleotide j (right_/left_neighbors_np's order).
    Runs on the device ``keys`` lies on."""
    nuc = torch.arange(4, dtype=torch.int64, device=keys.device)
    out = []
    for shift in (bp.shift_right, bp.shift_left):
        can = bp.canonical(shift(keys[:, None], nuc, k), k)
        idx, found = find(keys, can)
        out.append(torch.where(found, idx, -1))
    return tuple(out)


# keys of one row block of ``depth1_index``: its [B, 4] int64
# temporaries then take a few hundred MB of the device whatever the
# graph's size
_INDEX_BLOCK = 1 << 22


def depth1_index(keys: torch.Tensor, k: int):
    """(left, right) [N, 4] int32 host arrays of the native traversal
    (pivot_bfs_depth1), built on the device ``keys`` lies on: column j
    holds the index of the canonical neighbor through nucleotide j, -1
    where it is absent.  ``keys`` is sorted; where a key repeats (one
    .kmers.bin is sorted but not deduplicated) its index is the last of
    the run, the one the JAX package's native hash keeps, where
    ``neighbor_index`` gives the first.  Built in row blocks of
    _INDEX_BLOCK keys, each copied into its slice of the host tables."""
    n = keys.numel()
    nuc = torch.arange(4, dtype=torch.int64, device=keys.device)
    tables = (torch.empty((n, 4), dtype=torch.int32),
              torch.empty((n, 4), dtype=torch.int32))
    for s in range(0, n, _INDEX_BLOCK):
        block = keys[s:s + _INDEX_BLOCK, None]
        for out, shift in zip(tables, (bp.shift_left, bp.shift_right)):
            can = bp.canonical(shift(block, nuc, k), k)
            idx = torch.searchsorted(keys, can, right=True).sub_(1)
            found = keys[idx.clamp(min=0)] == can
            part = torch.where(found, idx, -1).to(torch.int32)
            trace.d2h(part)
            out[s:s + len(part)].copy_(part)
    trace.count("pivot_index_keys", n)
    return tuple(t.numpy() for t in tables)


class _Graph:
    """Index-space view: neighbor indices (or -1) per key.

    The index tables come from ``neighbor_index`` on ``device`` and are
    then held on the host: up to _LIST_MAX keys as plain Python lists (one
    element access costs ~5 us/node on lists vs 20.6 on numpy scalars,
    measured in tests/test_bfs_envelope.py), above it as numpy rows
    converted lazily per visited node."""

    def __init__(self, keys: np.ndarray, counts: np.ndarray, k: int,
                 device: str | torch.device):
        self.keys = keys
        self.counts = counts
        self.k = k
        trace.h2d(device, keys)
        tables = neighbor_index(torch.from_numpy(keys).to(device), k)
        trace.d2h(*tables)
        right, left = (t.cpu().numpy() for t in tables)
        if len(keys) <= _LIST_MAX:
            # list rows: ~4x faster per visited node; fine up to ~2 GB
            self.right = right.tolist()
            self.left = left.tolist()
            self.counts_l = counts.tolist()
        else:
            # numpy rows, converted lazily per visited node — the
            # traversal only touches pivot components, so table-sized
            # list materialization would be all memory and no speed
            self.right = right
            self.left = left
            self.counts_l = counts
        self.visited = bytearray(len(keys))

    def live(self, side, i: int) -> list[int]:
        """Unvisited neighbor indices on one side (with multiplicity)."""
        v = self.visited
        row = side[i]
        if not isinstance(row, list):
            row = row.tolist()
        return [j for j in row if j >= 0 and not v[j]]

    def away_side(self, i: int, prev: int):
        """Continuation side given the predecessor's INDEX.

        Mirrors the reference's two scans (left match -> go right, right
        match -> go left; the later scan wins,
        ComponentsBuilderAroundPivot.java:283-296).  The predecessor is
        always a graph node, so index membership in the neighbor-index
        rows is equivalent to the reference's key-membership scans."""
        side = None
        if prev in self.left[i]:
            side = self.right
        if prev in self.right[i]:
            side = self.left
        return side


def _order(out: list[PivotComponent]) -> list[PivotComponent]:
    out.sort(key=lambda c: (c.used_freq_threshold, -c.weight, -c.size,
                            int(c.kmers[0]) if c.size else 0))
    return out


def _pivot_flags(keys: np.ndarray, pivot_keys) -> np.ndarray:
    """[N] bool: the key is one of the pivot keys."""
    flags = np.zeros(len(keys), dtype=bool)
    if len(keys):
        pivot_keys = np.asarray(pivot_keys, dtype=np.int64)
        pidx = np.clip(np.searchsorted(keys, pivot_keys), 0, len(keys) - 1)
        flags[pidx[keys[pidx] == pivot_keys]] = True
    return flags


def split_around_pivot(keys: np.ndarray, counts: np.ndarray, k: int,
                       pivot_keys: np.ndarray, depth: int = 1,
                       device: str | torch.device = "cuda",
                       force_python: bool = False
                       ) -> list[PivotComponent]:
    """All pivot components of a counted graph (sorted keys required).

    depth == 1 (the dominant mode) routes the traversal through the
    native BFS (fastparse.cpp pivot_bfs_depth1, an exact mirror of the
    Python loop below): the traversal is inherently sequential — probe
    order and the visited set ARE the semantics — and per-node Python
    costs ~20 us where the native loop does ~50M nodes/s, which is what
    makes the 10^7-key chain-heavy worst case tractable (VERDICT r4 #4).
    Its int32 index tables are built on ``device`` (``depth1_index``)
    and copied to the host.  Deeper traversals, and a depth-1 one whose
    members overflow the native buffer, run the Python spec over
    ``_Graph`` tables built on ``device``.
    """
    keys = np.asarray(keys, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    if depth == 1 and not force_python:
        out = _split_around_pivot_native(keys, counts, k, pivot_keys,
                                         device)
        if out is not None:
            return out
    with trace.span("pivot.index"):
        g = _Graph(keys, counts, k, device)

    with trace.span("pivot.traverse"):
        piv_np = _pivot_flags(keys, pivot_keys)
        piv = bytearray(piv_np.tobytes())
        pivot_done = bytearray(len(keys))

        out = []
        for start in np.nonzero(piv_np)[0]:
            if pivot_done[start] or g.visited[start]:
                continue
            out.append(_bfs(g, int(start), piv, pivot_done, depth))
        return _order(out)


def _split_around_pivot_native(keys, counts, k, pivot_keys, device
                               ) -> list[PivotComponent] | None:
    """Depth-1 extraction via the native traversal over index tables
    built on ``device``; None on a members overflow (the caller falls
    back to the Python spec)."""
    lib = native_library()
    n = len(keys)
    if n == 0:
        return []
    with trace.span("pivot.index"):
        trace.h2d(device, keys)
        left, right = depth1_index(torch.from_numpy(keys).to(device), k)

    piv_np = _pivot_flags(keys, pivot_keys).astype(np.uint8)
    starts = np.nonzero(piv_np)[0].astype(np.int64)
    if len(starts) == 0:
        return []

    counts64 = np.ascontiguousarray(counts, dtype=np.int64)
    members_cap = 2 * n + 64
    members = np.empty(members_cap, dtype=np.int32)
    max_comps = len(starts) + 1
    comp_off = np.empty(max_comps + 1, dtype=np.int64)
    comp_w = np.empty(max_comps, dtype=np.int64)
    comp_p = np.empty(max_comps, dtype=np.int64)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    p8 = ctypes.POINTER(ctypes.c_uint8)
    with trace.span("pivot.traverse"):
        n_comp = lib.pivot_bfs_depth1(
            left.ctypes.data_as(p32), right.ctypes.data_as(p32),
            counts64.ctypes.data_as(p64), piv_np.ctypes.data_as(p8),
            n, starts.ctypes.data_as(p64), len(starts),
            members.ctypes.data_as(p32), members_cap,
            comp_off.ctypes.data_as(p64), comp_w.ctypes.data_as(p64),
            comp_p.ctypes.data_as(p64), max_comps)
        if n_comp < 0:
            _log.warning("pivot_bfs_depth1: members buffer overflow at %d "
                         "keys; taking the Python traversal", n)
            return None
        out = []
        for c in range(n_comp):
            m = members[comp_off[c]:comp_off[c + 1]]
            out.append(PivotComponent(
                kmers=np.sort(keys[np.unique(m.astype(np.int64))]),
                weight=int(comp_w[c]), n_pivot=int(comp_p[c])))
        return _order(out)


def _bfs(g: _Graph, start: int, piv: np.ndarray, pivot_done: np.ndarray,
         depth: int) -> PivotComponent:
    from collections import deque

    members: list[int] = []
    weight = 0
    n_pivot = 0
    queue: deque[tuple[int, int]] = deque()   # (index, parent index)

    def visit(i: int) -> None:
        nonlocal weight, n_pivot
        g.visited[i] = True
        members.append(i)
        weight += g.counts_l[i]
        if piv[i] and not pivot_done[i]:
            pivot_done[i] = True
            n_pivot += 1

    def probe(j: int, cur: int) -> tuple[int, list[int]]:
        """Walk the unique continuation from fork branch j; mark the path
        visited; return (#pivots on path, path indices)."""
        if depth == 1:
            return _probe_line(g, j, cur, piv, pivot_done)
        return _probe_deep(g, j, cur, piv, depth)

    def expand(i: int, side) -> None:
        """One side of the start k-mer, or the away side in the main loop."""
        nonlocal n_pivot
        nbrs = [j for j in side[i] if j >= 0 and not g.visited[j]]
        if not nbrs:
            return
        if len(nbrs) == 1:
            j = nbrs[0]
            visit(j)
            queue.append((j, i))
        else:
            for j in nbrs:
                if g.visited[j]:
                    continue
                n_piv, path = probe(j, i)
                if n_piv > 0:
                    visit(j)
                    n_pivot += n_piv
                    for p in path:
                        _add_path_member(p)
                    if len(path) >= 2:
                        queue.append((path[-1], path[-2]))
                    elif len(path) == 1:
                        queue.append((path[0], j))
                    else:
                        queue.append((j, i))

    def _add_path_member(p: int) -> None:
        nonlocal weight
        members.append(p)
        weight += g.counts_l[p]

    visit(start)
    expand(start, g.right)
    expand(start, g.left)

    while queue:
        i, prev = queue.popleft()
        side = g.away_side(i, prev)
        if side is None:
            continue
        expand(i, side)

    kmers = np.sort(g.keys[np.unique(
        np.fromiter(members, dtype=np.int64, count=len(members)))])
    return PivotComponent(kmers=kmers, weight=weight, n_pivot=n_pivot)


def _probe_line(g: _Graph, j: int, parent: int, piv: np.ndarray,
                pivot_done: np.ndarray) -> tuple[int, list[int]]:
    """depth==1 probe: follow unique continuations, consuming the path
    (ComponentsBuilderAroundPivot.dfs).  Marks pivots found as done."""
    path: list[int] = []
    n_pivot = 0
    cur = j
    prev = parent
    # the branch head itself is NOT consumed by a failed probe
    # (the reference dfs never marks `neighbour`, only path k-mers);
    # mark it temporarily so a cycle cannot re-enter it, restore below
    g.visited[j] = True
    while True:
        side = g.away_side(cur, prev)
        if side is None:
            break
        nbrs = [x for x in side[cur] if x >= 0 and not g.visited[x]]
        if len(nbrs) != 1:
            break
        nxt = nbrs[0]
        path.append(nxt)
        g.visited[nxt] = True
        if piv[nxt] and not pivot_done[nxt]:
            pivot_done[nxt] = True
            n_pivot += 1
        prev = cur
        cur = nxt
    if n_pivot == 0:
        g.visited[j] = False
    return n_pivot, path


def _probe_deep(g: _Graph, j: int, parent: int, piv: np.ndarray,
                depth: int) -> tuple[int, list[int]]:
    """depth>1 probe: exhaustive DFS up to `depth` k-mers, keep the
    pivot-richest path (DeepComponentsBuilderAroundPivot.dfs)."""
    best = {"n": 0, "path": []}

    def rec(cur: int, prev: int, path: list[int], n_piv: int,
            avail: int) -> None:
        if avail == 0:
            if n_piv > best["n"]:
                best["n"] = n_piv
                best["path"] = list(path)
            return
        side = g.away_side(cur, prev)
        nbrs = [] if side is None else \
            [x for x in side[cur] if x >= 0 and not g.visited[x]
             and x not in path and x != j]
        if not nbrs:
            if n_piv > best["n"]:
                best["n"] = n_piv
                best["path"] = list(path)
            return
        for x in nbrs:
            rec(x, cur, path + [x],
                n_piv + (1 if piv[x] else 0), avail - 1)

    g.visited[j] = True
    rec(j, parent, [], 0, depth)
    if best["n"] == 0:
        # deep probes are read-only on failure (the reference's deep dfs
        # never mutates hm; only the chosen best path is consumed)
        g.visited[j] = False
        return 0, []
    for p in best["path"]:
        g.visited[p] = True
    return best["n"], best["path"]

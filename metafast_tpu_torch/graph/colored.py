"""Colored k-mers: 3x20-bit packed per-class counts + colored components.

Parity: src/algo/ColoredKmerOperations.java (packing, saturation at
2^20-1, color call at relative abundance >= perc) and
src/algo/ColoredComponentsBuilder.java (per-color BFS; gray (-1 color)
k-mers are absorbed into components without being consumed, so they may
appear in several components; --linear walks the best same-color path at
forks; --separate restricts components to color-specific k-mers).

Determinism spec: start k-mers are scanned in ascending canonical-key
order (the reference iterates hash order).

Scale envelope (MEASURED, tests/test_bfs_envelope.py): neighbor lookups
are precomputed vectorized and the BFS is host Python at ~6 us/node
including table build (1M-node chain in ~6 s) — fine for the tool's
niche scale of a few million k-mers.  Bulk component extraction goes
through the device label propagation in graph/components.py.

Counterpart of metafast_tpu/graph/colored.py (:1-275).  Where it departs:
  - the native traversal's int32 index tables are built on the run's
    device (``pivot.depth1_index``, as the depth-1 pivot traversal's),
    where the JAX package builds them in a native hash on the host; the
    traversal itself is the port's native library, as there;
  - the native library is never missing in the port (a failed build
    raises), so the "no library" branch is gone; a members-buffer
    overflow still moves to the Python spec, with a warning.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import trace
from ..utils.native import native_library
from .pivot import depth1_index, left_neighbors_np, right_neighbors_np

# a child of the launcher's logger, so warnings reach the run's log
_log = logging.getLogger("metafast_torch.graph")

POWER = 20
COLOR_MAX = (1 << POWER) - 1


def get_value(values: np.ndarray, color: int) -> np.ndarray:
    v = np.asarray(values, dtype=np.uint64)
    return ((v >> np.uint64(color * POWER)) & np.uint64(COLOR_MAX)).astype(np.int64)


def add_value(values: np.ndarray, color: int, add) -> np.ndarray:
    """Saturating add into one color lane (ColoredKmerOperations.addValue)."""
    v = np.asarray(values, dtype=np.uint64)
    cur = get_value(v, color)
    new = np.minimum(cur + np.asarray(add, dtype=np.int64), COLOR_MAX)
    cleared = v & ~(np.uint64(COLOR_MAX) << np.uint64(color * POWER))
    return (cleared | (new.astype(np.uint64) << np.uint64(color * POWER))).astype(np.int64)


def get_color(values: np.ndarray, perc: float) -> np.ndarray:
    """Color call: class with share >= perc, else -1
    (ColoredKmerOperations.getColor)."""
    v = np.asarray(values, dtype=np.uint64)
    c0 = get_value(v, 0).astype(np.float64)
    c1 = get_value(v, 1).astype(np.float64)
    c2 = get_value(v, 2).astype(np.float64)
    s = c0 + c1 + c2
    with np.errstate(invalid="ignore", divide="ignore"):
        color = np.where(c0 / s >= perc, 0,
                         np.where(c1 / s >= perc, 1,
                                  np.where(c2 / s >= perc, 2, -1)))
    return color.astype(np.int32)


@dataclass
class ColoredComponent:
    kmers: np.ndarray
    weight: int
    color: int

    @property
    def size(self) -> int:
        return len(self.kmers)


def split_colored(keys: np.ndarray, values: np.ndarray, k: int,
                  n_groups: int = 3, separate: bool = False,
                  linear: bool = False, n_comps: int = -1,
                  perc: float = 0.9,
                  device: str | torch.device = "cuda"
                  ) -> dict[int, list[ColoredComponent]]:
    """All colored components, keyed by color (splitStrategy).  The
    default mode's index tables are built on ``device``."""
    keys = np.asarray(keys, dtype=np.int64)
    order = np.argsort(keys)
    keys, values = keys[order], np.asarray(values, dtype=np.int64)[order]
    N = len(keys)
    color = get_color(values, perc)

    if not linear and N:
        native = _split_colored_native(keys, color, k, n_groups,
                                       separate, n_comps, device)
        if native is not None:
            return native

    rn = right_neighbors_np(keys, k)
    ln = left_neighbors_np(keys, k)
    nbr_keys = np.concatenate([rn, ln], axis=1)       # [N, 8]
    idx = np.searchsorted(keys, nbr_keys)
    idx = np.clip(idx, 0, max(N - 1, 0))
    found = (keys[idx] == nbr_keys) if N else np.zeros_like(idx, dtype=bool)
    # python lists for the traversal: numpy scalar indexing costs ~20x a
    # list access on the queue-chasing path (tests/test_bfs_envelope.py)
    nbrs = np.where(found, idx, -1).astype(np.int64).tolist()
    color_l = color.tolist()

    visited = bytearray(N)
    ans: dict[int, list[ColoredComponent]] = {g: [] for g in range(n_groups)}
    per_group = [0] * n_groups

    for start in range(N):
        if n_comps != -1 and sum(per_group) >= n_groups * n_comps:
            break
        if visited[start]:
            continue
        c = int(color[start])
        if c == -1 or c >= n_groups:
            continue
        if n_comps != -1 and per_group[c] >= n_comps:
            continue
        comp = (_bfs_linear if linear else _bfs)(
            nbrs, color_l, visited, start, c, separate)
        if comp:
            per_group[c] += 1
            members = np.array(sorted(comp), dtype=np.int64)
            ans[c].append(ColoredComponent(
                kmers=keys[members], weight=len(comp), color=c))
    return ans


def _split_colored_native(keys, color, k, n_groups, separate, n_comps,
                          device) -> dict[int, list[ColoredComponent]] | None:
    """Default-mode traversal in C++ (fastparse.cpp colored_bfs — the
    exact mirror of _bfs below, ~50M nodes/s vs ~170K/s Python) over
    index tables built on ``device``.  None on a members overflow (the
    caller falls back to the Python spec)."""
    import ctypes

    lib = native_library()
    N = len(keys)
    trace.h2d(device, keys)
    left, right = depth1_index(torch.from_numpy(keys).to(device), k)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    # the python path iterates right columns first, then left
    nbrs = np.ascontiguousarray(
        np.concatenate([right, left], axis=1), dtype=np.int32)
    color8 = np.ascontiguousarray(color, dtype=np.int8)
    members_cap = 4 * N + 64
    members = np.empty(members_cap, dtype=np.int32)
    max_comps = N + 1
    comp_off = np.empty(max_comps + 1, dtype=np.int64)
    comp_col = np.empty(max_comps, dtype=np.int32)
    n_comp = lib.colored_bfs(
        nbrs.ctypes.data_as(p32),
        color8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        N, n_groups, 1 if separate else 0, n_comps,
        members.ctypes.data_as(p32), members_cap,
        comp_off.ctypes.data_as(p64), comp_col.ctypes.data_as(p32),
        max_comps)
    if n_comp < 0:
        _log.warning("colored_bfs: members buffer overflow at %d keys; "
                     "taking the Python traversal", N)
        return None
    ans: dict[int, list[ColoredComponent]] = {g: [] for g in range(n_groups)}
    for ci in range(n_comp):
        m = members[comp_off[ci]:comp_off[ci + 1]].astype(np.int64)
        c = int(comp_col[ci])
        ans[c].append(ColoredComponent(
            kmers=keys[np.sort(m)], weight=len(m), color=c))
    return ans


def _bfs(nbrs, color, visited, start, start_color, separate):
    from collections import deque

    comp: set[int] = set()
    queue = deque([start])
    visited[start] = True
    comp.add(start)
    while queue:
        i = queue.popleft()
        for j in nbrs[i]:
            if j < 0 or visited[j]:
                continue
            cj = color[j]
            if cj == start_color:
                visited[j] = True
                comp.add(j)
                queue.append(j)
            elif not separate and cj == -1 and j not in comp:
                # gray k-mers join without being consumed
                comp.add(j)
                queue.append(j)
    return comp


def _bfs_linear(nbrs, color, visited, start, start_color, separate):
    from collections import deque

    comp: set[int] = set()
    queue = deque([start])
    visited[start] = True
    comp.add(start)

    def live(i, exclude=-1):
        return [j for j in nbrs[i]
                if j >= 0 and not visited[j] and j != exclude]

    def count_color_on_path(j, prev):
        cnt = 0
        cur, pv = j, prev
        seen = set()
        while True:
            if visited[cur] or cur in seen:
                return -1 if visited[cur] else cnt
            seen.add(cur)
            if color[cur] == start_color:
                cnt += 1
            nxt = live(cur, exclude=pv)
            if len(nxt) == 1:
                pv, cur = cur, nxt[0]
            else:
                break
        return cnt

    def kmers_on_path(j, prev):
        path = []
        cur, pv = j, prev
        seen = set()
        while True:
            if visited[cur] or cur in seen:
                break
            seen.add(cur)
            path.append(cur)
            nxt = live(cur, exclude=pv)
            if len(nxt) == 1:
                pv, cur = cur, nxt[0]
            else:
                break
        return path

    while queue:
        i = queue.popleft()
        nl = live(i)
        if len(nl) > 1:
            best, best_good = None, -1
            for j in nl:
                good = count_color_on_path(j, i)
                if good > best_good:
                    best_good, best = good, j
            if best_good > 0:
                path = kmers_on_path(best, i)
                for v in path:
                    cv = int(color[v])
                    if cv == start_color:
                        visited[v] = True
                        comp.add(v)
                    elif cv == -1 and v not in comp:
                        comp.add(v)
                if path:
                    queue.append(path[-1])
        elif len(nl) == 1:
            j = nl[0]
            cj = int(color[j])
            if cj == start_color:
                visited[j] = True
                comp.add(j)
                queue.append(j)
            elif cj == -1 and j not in comp:
                comp.add(j)
                queue.append(j)
    return comp

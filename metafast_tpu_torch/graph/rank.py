"""List ranking over de Bruijn chain successors: splitter walks.

Counterpart of metafast_tpu/graph/rank.py.  The successor forest is
ranked in four steps (the Helman-JaJa decomposition):

  1. mark the walk starts: every head (indegree 0) plus a deterministic
     1/B hash sample of all nodes, the same nodes as in the JAX package;
  2. walk all starts forward in lockstep, one gather and one scatter a
     round, in segments of ``_SEG_ROUNDS`` rounds; a walk stops where the
     next node is a start or where its chain ends, and between segments
     the finished walks are flushed and the live ones compacted;
  3. rank the walk graph (about n/B walks) by pointer doubling;
  4. map (terminal, distance, reached) back to every node.

Nodes on a cycle with no start are left unvisited by the walks; a second
pass makes each of them a zero-step walk linked to its successor's walk.
Cycle walks never reach a terminal, so their nodes come out
reached=False, as with pointer doubling.

Where it departs from the JAX package: a node's walk record is one int64,
``walkid << 32 | offset``, so there is no packed-width limit, no "walk
count too large" error and no segment guard.  The successor function is
injective (a successor's left extension is never a fork), so the graph is
disjoint paths and cycles and every walk ends within n steps; the loop is
bounded at n steps and a breach raises as a broken invariant.  The live
walks are compacted by a boolean index, not into power-of-two width
buckets (those bounded XLA compile counts).

Reference parity anchor: the sequential walk this replaces is
src/algo/AddSequencesShiftingRightTask.java:74-99.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.hash32 import M32, mul32

# splitter sampling rate 1/B: mean gap B, longest gap ~B ln(n/B) steps
_B = 32

# rounds of the lockstep walk between two reads of the live count
_SEG_ROUNDS = 2 * _B


def _sampled(ids: torch.Tensor) -> torch.Tensor:
    """The 1/B hash sample of node ids in [0, 2^32): JAX _start_mask
    (:53) and _encode (:67), h = id * 0x9E3779B9 mod 2^32, h ^= h >> 16."""
    h = mul32(ids, 0x9E3779B9)
    h ^= h >> 16
    return (h & (_B - 1)) == 0


def _start_mask(succ: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Heads (indegree 0) and the hash sample, on valid nodes."""
    n = succ.numel()
    has_pred = torch.zeros(n + 1, dtype=torch.bool, device=succ.device)
    has_pred[torch.where(succ >= 0, succ, n)] = True
    ids = torch.arange(n, dtype=torch.int64, device=succ.device)
    return (~has_pred[:n] | _sampled(ids)) & valid


def _encode(succ: torch.Tensor) -> torch.Tensor:
    """The walk's step table: succ where the walk goes on, -1 at a chain
    end, -2 - succ where succ is a start.  A successor has a predecessor,
    so it is a start only through the hash sample."""
    stop = _sampled(succ.clamp(min=0)) & (succ >= 0)
    return torch.where(stop, -2 - succ, succ)


def _walk(enc: torch.Tensor, starts: torch.Tensor):
    """Pass 1: every start walked to its stop.  Returns the [n] walk
    records (walkid << 32 | offset, -1 unvisited), per walk the stop
    node (the chain end itself when the walk ends there), its steps and
    whether it ended at a chain end, and the number of segments."""
    n = enc.numel()
    dev = enc.device
    s = starts.numel()
    # slot n takes the writes of walks that did not move
    walkrec = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    wid = torch.arange(s, dtype=torch.int64, device=dev)
    walkrec[starts] = wid << 32
    res_stop = torch.full((s,), -1, dtype=torch.int64, device=dev)
    res_t = torch.zeros(s, dtype=torch.int64, device=dev)
    res_term = torch.zeros(s, dtype=torch.bool, device=dev)
    cur, t = starts, torch.zeros(s, dtype=torch.int64, device=dev)
    segments = 0
    while cur.numel():
        # a walk visits distinct nodes, so it ends within n rounds
        if segments * _SEG_ROUNDS >= n:
            raise RuntimeError(
                f"chain walk still live after {segments * _SEG_ROUNDS} "
                f"steps over {n} nodes: the successor graph is not "
                "injective")
        head = wid << 32
        for _ in range(_SEG_ROUNDS):
            g = enc[cur]
            adv = g >= 0
            cur = torch.where(adv, g, cur)
            t += adv
            walkrec[torch.where(adv, cur, n)] = head | t
        segments += 1
        g = enc[cur]
        fin = g < 0
        w, gf = wid[fin], g[fin]
        term = gf == -1
        res_stop[w] = torch.where(term, cur[fin], -2 - gf)
        res_t[w] = t[fin]
        res_term[w] = term
        live = ~fin
        cur, wid, t = cur[live], wid[live], t[live]
    return walkrec[:n], res_stop, res_t, res_term, segments


def _rank_walks(nxtw, gap, stop_node, term):
    """(steps to the terminal, terminal node, reached) per walk, by
    (ptr, dist) doubling over the walk graph (JAX _rank_walks :216).  The
    terminal walk points at itself with dist 0, so converged sums stop
    growing; its own gap is added once at the end."""
    s = nxtw.numel()
    ids = torch.arange(s, dtype=torch.int64, device=nxtw.device)
    ptr = torch.where(term, ids, nxtw)
    dist = torch.where(term, 0, gap + 1)
    for _ in range(int(np.ceil(np.log2(max(s, 2)))) + 2):
        nptr = ptr[ptr]
        dist = dist + dist[ptr]
        moved = bool((nptr != ptr).any())
        ptr = nptr
        if not moved:
            break
    return dist + gap[ptr], stop_node[ptr], term[ptr]


def chain_rank(succ: torch.Tensor, valid: torch.Tensor,
               need_rank: bool = True) -> dict:
    """List ranking of the successor forest.

    Args:
      succ:  [n] int64; succ[v] = next oriented node or -1.
      valid: [n] bool; nodes that exist (sentinel rows False).
      need_rank: False skips the walk-graph ranking.

    Returns a dict of tensors on succ's device:
      walkid [n]: the node's walk (-1 on invalid rows).  Pass-1 walks are
        numbered as in the JAX package (starts in ascending node order);
        cycle walks follow them at n_pass1 + i, where JAX numbers them
        from its padded width _pow2(n_pass1 + 1): the same partition,
        shifted ids.
      n_walks: the number of walks (an int);
      res_stop [n_walks]: each walk's stop node (its chain end when it
        ended there); res_term [n_walks]: whether it did;
      segments: the lockstep segments pass 1 ran (an int);
    and, when need_rank, term / dist / reached [n]: reached equals
    pointer doubling's on every valid row, term and dist on the reached
    ones (on cycle rows both are unspecified, as with doubling); invalid
    rows come out term -1, dist 0, reached False.
    """
    n = succ.numel()
    dev = succ.device
    is_start = _start_mask(succ, valid)
    starts = torch.nonzero(is_start).flatten()
    walkrec, res_stop, res_t, res_term, segments = _walk(_encode(succ),
                                                         starts)

    # pass 2: nodes on cycles without a start become zero-step walks
    nodes = torch.nonzero((walkrec < 0) & valid).flatten()
    if nodes.numel():
        cw = starts.numel() + torch.arange(nodes.numel(), dtype=torch.int64,
                                           device=dev)
        walkrec[nodes] = cw << 32
        nx = succ[nodes]
        res_stop = torch.cat([res_stop, torch.where(nx >= 0, nx, nodes)])
        res_t = torch.cat([res_t, torch.zeros_like(nodes)])
        res_term = torch.cat([res_term, nx < 0])

    visited = walkrec >= 0
    walkid = torch.where(visited, walkrec >> 32, -1)
    out = {"walkid": walkid, "n_walks": res_stop.numel(),
           "res_stop": res_stop, "res_term": res_term,
           "segments": segments}
    if not need_rank:
        return out
    if res_stop.numel() == 0:
        out.update(term=torch.full_like(succ, -1),
                   dist=torch.zeros_like(succ),
                   reached=torch.zeros_like(valid))
        return out

    nxtw = torch.where(res_term, -1, walkid[res_stop.clamp(0, n - 1)])
    D, tn, reachedw = _rank_walks(nxtw, res_t, res_stop, res_term)
    w = walkid.clamp(min=0)
    term = torch.where(visited, tn[w], -1)
    out.update(term=term,
               dist=torch.where(visited, D[w] - (walkrec & M32), 0),
               reached=visited & reachedw[w] & (term >= 0))
    return out

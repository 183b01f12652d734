"""Plain reference of the matrix-builder chain, in plain PyTorch and SciPy.

Written from the reference toolkit's semantics (ctlab/metafast:
KmersCounterMain, SeqBuilderMain, ComponentCutterMain,
FeaturesCalculatorMain, DistanceMatrixCalculatorMain), not from the
program under test, whose code it imports none of.  It works from the
generated reads alone (2-bit codes A=0, G=1, C=2, T=3; a k-mer is the
2k-bit integer of its codes, first base most significant; its key is
min(forward, reverse complement)) and runs on any torch device.

  count       every canonical k-mer of every read, counts saturating at
              32767; the sample's table keeps count > b
  contigs     maximal non-branching paths of the oriented de Bruijn graph
              over a table: u -> w when w is u's only right neighbour and
              u is w's only left neighbour (w != u); a path starts at a
              node without exactly one left neighbour, or whose one left
              neighbour has more than one right neighbour.  Each path and
              its reverse complement are one contig, written from the end
              with the smaller key (a one-k-mer path forward); kept when
              at least l long; weights are the mean (floor), min and max
              count of its k-mers
  components  all samples' contigs of length >= l recounted into one
              table; at threshold t = 1, 2, ... the graph over the live
              k-mers (neighbours: the 8 one-base extensions) is cut into
              connected components (scipy.sparse.csgraph); those of size
              in [b1, b2] are kept with weight = sum of counts, larger
              ones live on at t + 1 with their k-mers of count > t;
              ordered by (t, -weight, -size, least key)
  features    per sample and component, the sum of the sample's table
              counts over the component's k-mers, and the share of them
              present
  matrix      Bray-Curtis over the feature vectors, float64
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import connected_components

SATURATE = 32767
ASCII = np.frombuffer(b"AGCT", dtype=np.uint8)


@dataclass
class Result:
    """What one matrix-builder job must produce, in plain containers."""
    names: list[str]
    tables: list[tuple[np.ndarray, np.ndarray]]   # filtered (keys, counts)
    contigs: list[list[tuple]]     # per sample: (seq, length, av, min, max)
    components: list[tuple[int, np.ndarray]]      # (weight, sorted keys)
    vectors: np.ndarray            # [S, C] int64
    breadth: np.ndarray            # [S, C] float64
    matrix: np.ndarray             # [S, S] float64


def _mask(k: int) -> int:
    return (1 << (2 * k)) - 1


def revcomp(v: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of 2k-bit k-mer values (int64)."""
    out = torch.zeros_like(v)
    x = v ^ _mask(k)                 # complement: 3 - code
    for _ in range(k):
        out = (out << 2) | (x & 3)
        x = x >> 2
    return out


def canonical(v: torch.Tensor, k: int) -> torch.Tensor:
    return torch.minimum(v, revcomp(v, k))


def window_keys(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical keys of every k-window of each row of ``codes`` [R, L]."""
    R, L = codes.shape
    P = L - k + 1
    c = codes.to(torch.int64)
    fw = torch.zeros((R, P), dtype=torch.int64, device=codes.device)
    rc = torch.zeros_like(fw)
    for t in range(k):
        ct = c[:, t:t + P]
        fw |= ct << (2 * (k - 1 - t))
        rc |= (3 - ct) << (2 * t)
    return torch.minimum(fw, rc).reshape(-1)


def _merge(keys, counts, new_keys, new_counts):
    """Union of two (keys, counts) tables, counts summed."""
    allk = torch.cat([keys, new_keys])
    u, inv = torch.unique(allk, return_inverse=True)
    c = torch.zeros(u.numel(), dtype=torch.int64, device=u.device)
    c.index_add_(0, inv, torch.cat([counts, new_counts]))
    return u, c


def count(reads, k: int, device, block_rows: int = 1 << 17):
    """(keys, counts) of all canonical k-mers of ``reads`` (a list of
    [R, L] uint8 code arrays), ascending, counts saturated."""
    keys = torch.zeros(0, dtype=torch.int64, device=device)
    counts = torch.zeros(0, dtype=torch.int64, device=device)
    for arr in reads:
        for a in range(0, len(arr), block_rows):
            blk = torch.from_numpy(np.ascontiguousarray(
                arr[a:a + block_rows])).to(device)
            u, c = torch.unique(window_keys(blk, k), return_counts=True)
            keys, counts = _merge(keys, counts, u, c)
    return keys, counts.clamp(max=SATURATE)


def _lookup(keys: torch.Tensor, vals: torch.Tensor, k: int):
    """Oriented node of each k-mer value (index of its key, + M when the
    value is the key's reverse complement) and whether it is present."""
    M = keys.numel()
    can = canonical(vals, k)
    idx = torch.searchsorted(keys, can).clamp(max=max(M - 1, 0))
    found = keys[idx] == can
    return idx + torch.where(vals == can, 0, M), found


def contigs(keys: torch.Tensor, counts: torch.Tensor, k: int, l: int):
    """Contigs of a filtered table: [(seq, length, av, min, max)] ordered
    by the key of their first k-mer."""
    M = keys.numel()
    if M == 0:
        return []
    dev = keys.device
    mask = _mask(k)
    vals = torch.cat([keys, revcomp(keys, k)])     # node i: fw, M + i: rc
    n = 2 * M
    nuc = torch.arange(4, dtype=torch.int64, device=dev)[:, None]
    right, r_ok = _lookup(keys, ((vals[None] << 2) | nuc) & mask, k)
    left, l_ok = _lookup(keys, (vals[None] >> 2) | (nuc << (2 * k - 2)), k)
    outdeg, indeg = r_ok.sum(0), l_ok.sum(0)
    nodes = torch.arange(n, dtype=torch.int64, device=dev)
    nxt = right.gather(0, r_ok.to(torch.int8).argmax(0)[None])[0]
    prv = left.gather(0, l_ok.to(torch.int8).argmax(0)[None])[0]
    has = (outdeg == 1) & (indeg[nxt] == 1) & (nxt != nodes)
    succ = torch.where(has, nxt, -1)
    start = (indeg != 1) | (outdeg[prv] != 1)

    # each node's last node and distance to it, by pointer jumping
    last = torch.where(has, succ, nodes)
    dist = has.to(torch.int64)
    for _ in range(int(np.ceil(np.log2(n))) + 2):
        dist = dist + dist[last]
        last = last[last]
    ends = succ[last] < 0

    s = torch.nonzero(start & ends).flatten()
    ks, kt = keys[s % M], keys[last[s] % M]
    length = k + dist[s]
    emit = (length >= l) & ((ks < kt) | ((ks == kt) & ((dist[s] > 0)
                                                         | (s < M))))
    s = s[emit]
    if s.numel() == 0:
        return []
    s = s[torch.sort(keys[s % M], stable=True).indices]
    length = k + dist[s]
    C = s.numel()

    # members: every node that ends where a kept path ends
    row = torch.full((n,), -1, dtype=torch.int64, device=dev)
    row[last[s]] = torch.arange(C, device=dev)
    u = torch.nonzero(ends & (row[last] >= 0)).flatten()
    r = row[last[u]]
    w = counts[u % M].to(torch.int64)
    wsum = torch.zeros(C, dtype=torch.int64, device=dev).index_add_(0, r, w)
    wmin = torch.full((C,), SATURATE + 1, dtype=torch.int64,
                      device=dev).scatter_reduce_(0, r, w, "amin")
    wmax = torch.zeros(C, dtype=torch.int64,
                       device=dev).scatter_reduce_(0, r, w, "amax")

    # characters: the first k-1 of the start, then each member's last base
    off = torch.cumsum(length, 0) - length
    buf = torch.zeros(int(length.sum()), dtype=torch.int64, device=dev)
    pos = off[r] + (k - 1) + (dist[s][r] - dist[u])
    buf[pos] = vals[u] & 3
    t = torch.arange(k - 1, device=dev)
    buf[(off[:, None] + t).reshape(-1)] = (
        (vals[s][:, None] >> (2 * (k - 1 - t))) & 3).reshape(-1)

    text = ASCII[buf.cpu().numpy()].tobytes().decode("ascii")
    off, length = off.cpu().tolist(), length.cpu().tolist()
    av = (wsum // (torch.tensor(length, device=dev) - k + 1)).cpu().tolist()
    mn, mx = wmin.cpu().tolist(), wmax.cpu().tolist()
    return [(text[o:o + L], L, a, b, c)
            for o, L, a, b, c in zip(off, length, av, mn, mx)]


def contig_kmers(seqs: list[str], k: int, device):
    """(keys, counts) of every canonical k-mer of the given sequences."""
    if not seqs:
        z = torch.zeros(0, dtype=torch.int64, device=device)
        return z, z
    lut = np.full(256, 255, dtype=np.uint8)
    lut[np.frombuffer(b"AGCT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)
    codes = torch.from_numpy(lut[np.frombuffer("".join(seqs).encode(),
                                              dtype=np.uint8)]).to(device)
    lens = torch.tensor([len(q) for q in seqs], dtype=torch.int64,
                        device=device)
    end = torch.cumsum(lens, 0)
    N = codes.numel()
    P = N - k + 1
    c = codes.to(torch.int64)
    fw = torch.zeros(P, dtype=torch.int64, device=device)
    rc = torch.zeros_like(fw)
    for t in range(k):
        fw |= c[t:t + P] << (2 * (k - 1 - t))
        rc |= (3 - c[t:t + P]) << (2 * t)
    at = torch.arange(P, device=device)
    seq_end = end[torch.searchsorted(end, at, right=True)]
    km = torch.minimum(fw, rc)[at + k <= seq_end]
    keys, cnt = torch.unique(km, return_counts=True)
    return keys, cnt.clamp(max=SATURATE)


def _edges(keys: torch.Tensor, k: int):
    """Neighbour pairs (i, j), i < j, as host arrays."""
    mask = _mask(k)
    nuc = torch.arange(4, dtype=torch.int64, device=keys.device)[:, None]
    cand = torch.cat([((keys[None] << 2) | nuc) & mask,
                      (keys[None] >> 2) | (nuc << (2 * k - 2))])
    can = canonical(cand, k)
    idx = torch.searchsorted(keys, can).clamp(max=keys.numel() - 1)
    src = torch.arange(keys.numel(), device=keys.device).expand_as(idx)
    ok = (keys[idx] == can) & (src < idx)
    return src[ok].cpu().numpy(), idx[ok].cpu().numpy()


def components(keys: torch.Tensor, counts: torch.Tensor, k: int,
               b1: int, b2: int):
    """[(weight, sorted keys)] of the size-window split."""
    M = keys.numel()
    if M == 0:
        return []
    hkeys = keys.cpu().numpy()
    hcounts = counts.cpu().numpy().astype(np.int64)
    src, dst = _edges(keys, k)
    live = np.ones(M, dtype=bool)
    found = []
    t = 1
    while live.any():
        # dead k-mers keep no edge, so each is a component of its own
        e = live[src] & live[dst]
        g = sp.csr_matrix((np.ones(int(e.sum()), dtype=np.int8),
                           (src[e], dst[e])), shape=(M, M))
        _, lab = connected_components(g, directed=False)
        ids = np.flatnonzero(live)
        lab = lab[ids]
        size = np.bincount(lab)[lab]
        big = ids[size > b2]
        live = np.zeros(M, dtype=bool)
        live[big[hcounts[big] > t]] = True
        keep = (size >= b1) & (size <= b2)
        order = np.argsort(lab[keep], kind="stable")
        kid, klab = ids[keep][order], lab[keep][order]
        for grp in np.split(kid, np.flatnonzero(np.diff(klab)) + 1):
            if len(grp):
                found.append((t, int(hcounts[grp].sum()), hkeys[grp]))
        t += 1
    found.sort(key=lambda c: (c[0], -c[1], -len(c[2]), int(c[2][0])))
    return [(w, km) for _, w, km in found]


def features(comps, keys: torch.Tensor, counts: torch.Tensor):
    """(vector int64 [C], breadth float64 [C]) of one sample's table."""
    C = len(comps)
    if C == 0 or keys.numel() == 0:
        return np.zeros(C, dtype=np.int64), np.zeros(C, dtype=np.float64)
    q = torch.from_numpy(np.concatenate([km for _, km in comps])).to(
        keys.device)
    idx = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
    hit = (keys[idx] == q).cpu().numpy()
    val = np.where(hit, counts[idx].cpu().numpy().astype(np.int64), 0)
    sizes = np.array([len(km) for _, km in comps])
    seg = np.repeat(np.arange(C), sizes)
    vec = np.bincount(seg, weights=val, minlength=C).astype(np.int64)
    hits = np.bincount(seg, weights=hit, minlength=C).astype(np.int64)
    return vec, hits / sizes


def bray_curtis(vectors: np.ndarray) -> np.ndarray:
    """Pairwise Bray-Curtis distance, float64 (0 where both are empty)."""
    v = vectors.astype(np.float64)
    num = np.abs(v[:, None, :] - v[None, :, :]).sum(-1)
    tot = v.sum(-1)
    den = tot[:, None] + tot[None, :]
    d = np.divide(num, den, out=np.zeros_like(num), where=den > 0)
    np.fill_diagonal(d, 0.0)
    return d


def run(samples, params: dict, device, seconds: dict | None = None
        ) -> Result:
    """The whole chain over generated samples (objects with ``name`` and
    ``reads``, a pair of [R, L] code arrays), samples in name order, at
    the configuration's ``params`` (k, b, l, b1, b2).  ``seconds``, if
    given, receives each stage's host seconds."""
    k, b, l = params["k"], params["b"], params["l"]
    b1, b2 = params["b1"], params["b2"]
    samples = sorted(samples, key=lambda s: s.name)
    seconds = {} if seconds is None else seconds
    tables, all_contigs, dev_tables = [], [], []
    clock = time.perf_counter()

    def lap(stage):
        nonlocal clock
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[stage] = seconds.get(stage, 0.0) + now - clock
        clock = now

    for smp in samples:
        keys, cnt = count(smp.reads, k, device)
        keep = cnt > b
        keys, cnt = keys[keep], cnt[keep]
        dev_tables.append((keys, cnt))
        tables.append((keys.cpu().numpy(), cnt.cpu().numpy()))
        lap("count")
        all_contigs.append(contigs(keys, cnt, k, l))
        lap("contigs")
    gk, gc = contig_kmers([c[0] for cs in all_contigs for c in cs
                           if c[1] >= l], k, device)
    lap("recount")
    comps = components(gk, gc, k, b1, b2)
    lap("components")
    feats = [features(comps, kk, cc) for kk, cc in dev_tables]
    lap("features")
    C = len(comps)
    vectors = (np.stack([f[0] for f in feats]) if feats
               else np.zeros((0, C), dtype=np.int64))
    breadth = (np.stack([f[1] for f in feats]) if feats
               else np.zeros((0, C), dtype=np.float64))
    return Result(names=[s.name for s in samples], tables=tables,
                  contigs=all_contigs, components=comps, vectors=vectors,
                  breadth=breadth, matrix=bray_curtis(vectors))

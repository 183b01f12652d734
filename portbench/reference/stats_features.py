"""Plain reference of pipeline 5, stats-features, in plain PyTorch and NumPy.

Written from the reference toolkit's semantics (ctlab/metafast:
StatsFeaturesBuilderMain, KmerCounterPosNeg, StatsKmersFinder,
ComponentsBuilderAroundPivot, FeaturesCalculatorMain,
ComponentsToSequences), not from the program under test, whose code it
imports none of.  It reuses the counting, canonical keys and contig
building of ``reference/matrix.py``, the benchmark's own reference, and
runs on any torch device: the table stages there, the traversal on the
host.  Group A is the positive group, group B the negative one; S_A and
S_B are their sizes, S = S_A + S_B.

  tables      each sample's canonical k-mers counted from its reads,
              counts saturating at 32767, count > b kept; a sample's
              total is the sum of its table's counts
  presence    n1A, n1B: the samples of each group in whose table a key of
              the union is present; a key is scarce when n1A + n1B <=
              ceil(0.05 S) and in all when n1A + n1B = S; both skipped
  chi2        the percent-normalised Yates 2x2 statistic of (S_A - n1A,
              n1A, S_B - n1B, n1B) in float32 as the Java computes it in
              float (StatsKmersFinder.java:297-315); each term's |a - x|
              is a float widened to double before 0.5 is taken off, and
              squared and divided in double; a key survives when its
              statistic is strictly above the df = 1 inverse CDF at
              1 - pchi2 (3.841458820694124 at 0.05)
  mw          on the survivors: each sample's count (its table's record,
              0 where absent) times mean_sum, over the sample's total, in
              float64 (mean_sum: the mean of the S totals); commons-math3
              MannWhitneyUTest: average ranks for ties, U_min, sigma^2 =
              n1 n2 (n1 + n2 + 1) / 12, p = 2 Phi(z), no tie or continuity
              correction; kept when p < pmw (pmw = 0 keeps every survivor);
              to group A when meanA > meanB, else to group B, written with
              the group's mean (summed in sample order, over the group
              size) truncated to an int and narrowed to a short, as Java's
              (short) cast does
  extract     ComponentsBuilderAroundPivot at depth 1 over the positive
              tables merged (counts summed, saturating at 32767), from
              the records of filtered_groupA with a value above 0 (a k-mer
              file is loaded with threshold 0); see below
  features    per positive sample and component: the component's k-mers
              that are records of filtered_groupA with a value above 0,
              the sum of the sample's counts over them and the share of
              them present (features-calculator's defaults, threshold 0);
              every component holds its starting pivot, so none is empty
  comp2seq    the components' k-mers counted with b = 0 (each component
              written as FASTA, then kmer-counter-many), then the contigs
              of seq-builder-many at b = 0 and l = k

Extraction at depth 1, from ComponentsBuilderAroundPivot.java.  Every
k-mer has up to four neighbours on each side (its key shifted one base
left or right, made canonical), taken in the order of the added
nucleotide A, G, C, T.  A component starts at each pivot that no earlier
component reached; it takes the start, then grows each side of it, and
then the queue of (k-mer, the k-mer it was reached from).  A queued
k-mer grows on its side away from its predecessor (the right side if
the predecessor is among its left neighbours, the left side if among its
right ones, the later test winning; neither: it stops).  Growing a side
looks at its neighbours not yet taken, counted with repetition: one is
taken and queued; of several, each still untaken in turn is probed.  A
probe walks from the branch k-mer while exactly one untaken neighbour
continues the path on the away side, taking each k-mer of the path as it
goes and marking the pivots it passes as reached.  A probe that reached
a pivot takes the branch k-mer and the path into the component, adds
their counts to its weight and queues the path's last k-mer (reached from
the one before it); one that reached none leaves the branch k-mer free,
but its path stays taken.  A component's weight is the sum of its
k-mers' counts, its pivots those it took or whose probe reached them.
Components are ordered by weight, descending, then size, descending,
then least key.

Departures from upstream:
  - the order is fixed: pivots in ascending canonical key, fork branches
    in neighbour-nucleotide order (A, G, C, T), probe paths that fail
    stay taken.  Upstream iterates hash maps, so its order, and so which
    component takes a k-mer two pivots can reach, follows its hash
    layout; nothing else could be compared, and this order is the one
    the program documents.
  - the deep variant (DeepComponentsBuilderAroundPivot, depth > 1) adds a
    path k-mer's pivot-map value to the weight and counts a pivot once a
    path k-mer; the program adds the graph count and counts once a path.
    That departure does not apply here: the extractor runs at depth 1.
  - a component's size in components-stat.txt and its pivot count are
    not compared; components.bin (weight and keys) is.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch
from scipy.stats import chi2 as chi2_dist

from . import matrix

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SATURATE = matrix.SATURATE
SCARCE_SHARE = 0.05
_MW_ROWS = 1 << 20          # rows ranked at once (an [R, S, S] compare)


@dataclass
class Result:
    """What one stats-features job must produce, in plain containers."""
    names: list[str]                  # every sample, in name order
    positive: list[str]               # the positive group's, in name order
    tables: list[tuple[np.ndarray, np.ndarray]]   # per name: (keys, counts)
    chi2: np.ndarray                  # chi-squared survivors, ascending
    group_a: tuple[np.ndarray, np.ndarray]        # (keys, int16 values)
    group_b: tuple[np.ndarray, np.ndarray]
    components: list[tuple[int, np.ndarray]]      # (weight, sorted keys)
    vectors: np.ndarray               # [positive, C] int64
    breadth: np.ndarray               # [positive, C] float64
    sequences: list[tuple]            # comp2seq's (seq, len, av, min, max)


def presence(tables, keys: torch.Tensor) -> torch.Tensor:
    """In how many of ``tables`` each key of ``keys`` (ascending, the
    union of every table) is present."""
    n = torch.zeros(keys.numel(), dtype=torch.int64, device=keys.device)
    for tk, _ in tables:
        n.index_add_(0, torch.searchsorted(keys, tk),
                     torch.ones_like(tk))
    return n


def chi2_statistic(n0A, n1A, n0B, n1B) -> torch.Tensor:
    """StatsKmersFinder.chisq: float arithmetic in float32, each term's
    |a - x| widened to double before 0.5 is taken off."""
    c0, c1, p0, p1 = (t.to(torch.float32) for t in (n0A, n1A, n0B, n1B))
    c0n, c1n = 100 * c0 / (c0 + c1), 100 * c1 / (c0 + c1)
    p0n, p1n = 100 * p0 / (p0 + p1), 100 * p1 / (p0 + p1)
    gr1, gr2 = c0n + c1n, p0n + p1n
    total = gr1 + gr2
    x1 = gr1 / total * (p1n + c1n)
    x2 = gr1 / total * (p0n + c0n)
    x3 = gr2 / total * (p1n + c1n)
    x4 = gr2 / total * (p0n + c0n)

    def term(a, x):
        d = (a - x).abs().to(torch.float64) - 0.5
        return d * d / x.to(torch.float64)

    return term(p1n, x1) + term(p0n, x2) + term(c1n, x3) + term(c0n, x4)


def counts_of(tables, keys: torch.Tensor) -> torch.Tensor:
    """[N, len(tables)] each table's count of each key, 0 where absent."""
    out = torch.zeros((keys.numel(), len(tables)), dtype=torch.int64,
                      device=keys.device)
    for j, (tk, tc) in enumerate(tables):
        if tk.numel() == 0:
            continue
        idx = torch.searchsorted(tk, keys).clamp(max=tk.numel() - 1)
        out[:, j] = torch.where(tk[idx] == keys, tc[idx], 0)
    return out


def mann_whitney_p(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two-sided Mann-Whitney p of each row of a [N, n1] against b [N, n2]
    (commons-math3 MannWhitneyUTest, no tie correction)."""
    n1, n2 = a.shape[1], b.shape[1]
    sigma = math.sqrt(n1 * n2 * (n1 + n2 + 1) / 12.0)
    out = torch.empty(a.shape[0], dtype=torch.float64, device=a.device)
    for lo in range(0, a.shape[0], _MW_ROWS):
        z = torch.cat([a[lo:lo + _MW_ROWS], b[lo:lo + _MW_ROWS]], 1)
        below = (z[:, :, None] > z[:, None, :]).sum(-1)
        ties = (z[:, :, None] == z[:, None, :]).sum(-1)   # itself included
        rank = below.to(torch.float64) + (ties.to(torch.float64) + 1) / 2
        u1 = rank[:, :n1].sum(1) - n1 * (n1 + 1) / 2.0
        u = torch.minimum(u1, n1 * n2 - u1)
        out[lo:lo + _MW_ROWS] = 2.0 * torch.special.ndtr(
            (u - n1 * n2 / 2.0) / sigma)
    return out


def row_means(x: torch.Tensor) -> torch.Tensor:
    """Each row's mean, summed left to right and divided by its length."""
    total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        total = total + x[:, j]
    return total / x.shape[1]


def as_short(values: np.ndarray) -> np.ndarray:
    """Java's (short) of doubles: truncated to an int, then narrowed."""
    return np.trunc(values).astype(np.int64).astype(np.int16)


def select(pos, neg, pchi2: float, pmw: float):
    """(chi2 survivors, (group A keys, values), (group B keys, values)) of
    two groups of device tables, all on the host."""
    dev = pos[0][0].device
    S = len(pos) + len(neg)
    keys = torch.unique(torch.cat([t[0] for t in pos + neg]))
    n1A, n1B = presence(pos, keys), presence(neg, keys)
    present = n1A + n1B
    eligible = ((present > math.ceil(S * SCARCE_SHARE))
                & (present != S))
    stat = chi2_statistic(len(pos) - n1A, n1A, len(neg) - n1B, n1B)
    critical = float(chi2_dist.ppf(1.0 - pchi2, 1))     # df = 1
    chi_keys = keys[eligible & (stat > critical)]

    totals = [t[1].sum().item() for t in pos + neg]
    mean_sum = float(sum(totals)) / S
    a = counts_of(pos, chi_keys).to(torch.float64)
    b = counts_of(neg, chi_keys).to(torch.float64)
    a = a * mean_sum / torch.tensor(totals[:len(pos)], dtype=torch.float64,
                                    device=dev)
    b = b * mean_sum / torch.tensor(totals[len(pos):], dtype=torch.float64,
                                    device=dev)
    if pmw > 0 and chi_keys.numel():
        keep = mann_whitney_p(a, b) < pmw
    else:
        keep = torch.ones(chi_keys.numel(), dtype=torch.bool, device=dev)
    mean_a, mean_b = row_means(a), row_means(b)
    to_a = keep & (mean_a > mean_b)
    to_b = keep & ~(mean_a > mean_b)
    hk = chi_keys.cpu().numpy()

    def group(mask, mean):
        m = mask.cpu().numpy()
        return hk[m], as_short(mean.cpu().numpy()[m])

    return hk, group(to_a, mean_a), group(to_b, mean_b)


def merge(tables):
    """One table of several: counts summed, saturating at 32767."""
    keys, inv = torch.unique(torch.cat([t[0] for t in tables]),
                             return_inverse=True)
    counts = torch.zeros(keys.numel(), dtype=torch.int64, device=keys.device)
    counts.index_add_(0, inv, torch.cat([t[1] for t in tables]))
    return keys, counts.clamp(max=SATURATE)


def neighbours(keys: torch.Tensor, k: int):
    """(right, left): [N * 4] int32 on the host, the index of each key's
    canonical neighbour through nucleotide j at [4 i + j], -1 if absent."""
    mask = (1 << (2 * k)) - 1
    nuc = torch.arange(4, dtype=torch.int64, device=keys.device)
    out = []
    for cand in (((keys[:, None] << 2) | nuc) & mask,
                 (keys[:, None] >> 2) | (nuc << (2 * k - 2))):
        can = matrix.canonical(cand, k)
        idx = torch.searchsorted(keys, can).clamp(max=keys.numel() - 1)
        out.append(torch.where(keys[idx] == can, idx, -1)
                   .to(torch.int32).reshape(-1).cpu().numpy())
    return out


def extract(keys: torch.Tensor, counts: torch.Tensor, pivots: np.ndarray,
            k: int) -> list[tuple[int, np.ndarray]]:
    """[(weight, sorted keys)] of the depth-1 extraction (see the module's
    docstring) over a graph table (keys ascending) from ``pivots``."""
    N = keys.numel()
    if N == 0 or len(pivots) == 0:
        return []
    right, left = (memoryview(t) for t in neighbours(keys, k))
    hkeys = keys.cpu().numpy()
    weight_of = memoryview(counts.cpu().numpy().astype(np.int64))
    at = np.searchsorted(hkeys, pivots).clip(max=N - 1)
    starts = np.unique(at[hkeys[at] == pivots])
    is_pivot = bytearray(N)
    for s in starts.tolist():
        is_pivot[s] = 1
    reached = bytearray(N)          # pivots a component has reached
    taken = bytearray(N)

    def free_side(side, i):
        return [j for j in side[4 * i:4 * i + 4].tolist()
                if j >= 0 and not taken[j]]

    def away(i, prev):
        side = None
        if prev in left[4 * i:4 * i + 4].tolist():
            side = right
        if prev in right[4 * i:4 * i + 4].tolist():
            side = left
        return side

    def probe(j, parent):
        """(pivots reached, path) of the walk from branch k-mer j."""
        taken[j] = 1
        found, path, prev, cur = 0, [], parent, j
        while True:
            side = away(cur, prev)
            if side is None:
                break
            nxt = free_side(side, cur)
            if len(nxt) != 1:
                break
            nxt = nxt[0]
            path.append(nxt)
            taken[nxt] = 1
            if is_pivot[nxt] and not reached[nxt]:
                reached[nxt] = 1
                found += 1
            prev, cur = cur, nxt
        if not found:
            taken[j] = 0
        return found, path

    comps = []
    for start in starts.tolist():
        if reached[start] or taken[start]:
            continue
        members, queue = [], []

        def take(i):
            taken[i] = 1
            members.append(i)
            if is_pivot[i]:
                reached[i] = 1

        def grow(i, side):
            nxt = free_side(side, i)
            if len(nxt) == 1:
                take(nxt[0])
                queue.append((nxt[0], i))
                return
            for j in nxt:
                if taken[j]:
                    continue
                found, path = probe(j, i)
                if found:
                    take(j)
                    members.extend(path)
                    queue.append((path[-1], path[-2] if len(path) > 1
                                  else j))

        take(start)
        grow(start, right)
        grow(start, left)
        head = 0
        while head < len(queue):
            i, prev = queue[head]
            head += 1
            side = away(i, prev)
            if side is not None:
                grow(i, side)
        idx = np.array(members, dtype=np.int64)
        comps.append((sum(weight_of[i] for i in members),
                      np.sort(hkeys[idx])))
    comps.sort(key=lambda c: (-c[0], -len(c[1]), int(c[1][0])))
    return comps


def run(samples, params: dict, device, seconds: dict | None = None
        ) -> Result:
    """The whole pipeline over generated samples (objects with ``name``
    and ``reads``), at the configuration's ``params``: k, b, pchi2, pmw
    and ``groups``, the site of each group ({"pos": "site1", ...}); a
    sample belongs to site ``s`` when its name starts with ``s_``.
    ``seconds``, if given, receives each stage's host seconds."""
    k, b = params["k"], params["b"]
    groups = params["groups"]
    samples = sorted(samples, key=lambda s: s.name)
    seconds = {} if seconds is None else seconds
    clock = time.perf_counter()

    def lap(stage):
        nonlocal clock
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        seconds[stage] = seconds.get(stage, 0.0) + now - clock
        clock = now

    dev_tables = {}
    for smp in samples:
        keys, cnt = matrix.count(smp.reads, k, device)
        keep = cnt > b
        dev_tables[smp.name] = (keys[keep], cnt[keep])
    lap("count")

    def members(site):
        return [s.name for s in samples if s.name.startswith(site + "_")]

    positive, negative = members(groups["pos"]), members(groups["neg"])
    pos = [dev_tables[n] for n in positive]
    chi_keys, group_a, group_b = select(
        pos, [dev_tables[n] for n in negative], params["pchi2"],
        params["pmw"])
    lap("stats")

    sel = group_a[0][group_a[1] > 0]        # loaded with threshold 0
    gkeys, gcounts = merge(pos)
    comps = extract(gkeys, gcounts, sel, k)
    lap("extract")

    sizes = np.cumsum([len(km) for _, km in comps])[:-1]
    chosen = [(w, km[hit]) for (w, km), hit in zip(comps, np.split(
        np.isin(np.concatenate([km for _, km in comps] or [sel[:0]]), sel),
        sizes))]
    feats = [matrix.features(chosen, *dev_tables[n]) for n in positive]
    C = len(comps)
    vectors = (np.stack([f[0] for f in feats]) if feats
               else np.zeros((0, C), dtype=np.int64))
    breadth = (np.stack([f[1] for f in feats]) if feats
               else np.zeros((0, C), dtype=np.float64))
    lap("features")

    sequences = []
    if comps:
        ck, cc = torch.unique(torch.from_numpy(np.concatenate(
            [km for _, km in comps])).to(device), return_counts=True)
        sequences = matrix.contigs(ck, cc.clamp(max=SATURATE), k, k)
    lap("comp2seq")
    return Result(
        names=[s.name for s in samples], positive=positive,
        tables=[tuple(t.cpu().numpy() for t in dev_tables[s.name])
                for s in samples],
        chi2=chi_keys, group_a=group_a, group_b=group_b, components=comps,
        vectors=vectors, breadth=breadth, sequences=sequences)

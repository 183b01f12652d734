"""Simple-path contig extraction by pointer doubling.

Counterpart of metafast_tpu/graph/contigs.py (:104-350).  Reference
semantics (src/algo/AddSequencesShiftingRightTask.java): walk right from
every "left end" oriented k-mer while the right extension is unique and
the next k-mer's left extension is unique; emit sequences >= l,
deduplicated by the canonical-key rule startKey < endKey.

The walk rules define a successor function on oriented k-mers (node i is
key i forward, M + i its reverse complement); chains are ranked by Wyllie
pointer doubling on the device and assembled on the host.  The JAX
package ranks large tables on its TPU with splitter walks instead; the
port has them (graph/rank.chain_rank) but measured them slower here, so
they serve the component labels only (see chain_structure).

Spec notes (as in the JAX package, parity-safe):
  - a self-successor (u -> u, e.g. poly-A) is treated as null; the
    reference would not terminate on this input;
  - palindromic keys (even k only) give the fw and rc nodes one chain;
    it is emitted once;
  - output is sorted by start key (the reference's order depends on
    thread scheduling; downstream recounts k-mers, so order is
    irrelevant there).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import bitpack as bp
from ..utils import trace
from ..utils.kmers import kmer_string, rc64
from . import dbg

CHARS = np.frombuffer(b"AGCT", dtype=np.uint8)


def _succ_from_tables(keys: torch.Tensor, L: dict, R: dict, k: int):
    """Successor, chain-head flag and final nucleotide of each oriented
    node ([2M] each; succ -1 = none)."""
    M = keys.numel()
    pal = bp.rc(keys, k) == keys
    valid = ~bp.is_sentinel(keys)
    idx = torch.arange(M, dtype=torch.int64, device=keys.device)
    extL, extR = L["ext"], R["ext"]

    def pick(tab, nuc):
        """tab[nuc[i], i] per element (clipped for nuc < 0)."""
        return tab.gather(0, nuc.clamp(0, 3)[None, :])[0]

    lut = torch.stack([extL, extR, pal.to(torch.int64)])

    def peek(j):
        g = lut[:, j.clamp(0, M - 1)]
        return g[0], g[1], g[2] != 0

    # successor of the fw orientation
    j_fw = pick(R["idx"], extR)
    eL, eR, pal_j = peek(j_fw)
    arr_is_fw = pick(R["is_fw"], extR) | pal_j
    extL_arr = torch.where(arr_is_fw, eL, dbg.ext_map_rc(eR))
    node = j_fw + torch.where(arr_is_fw, 0, M)
    ok = (extR >= 0) & (extL_arr != dbg.FORK) & (node != idx) & valid
    succ_fw = torch.where(ok, node, -1)

    # successor of the rc orientation: rc of the left candidate
    j_rc = pick(L["idx"], extL)
    eL, eR, pal_j = peek(j_rc)
    arr_is_fw = ~pick(L["is_fw"], extL) | pal_j
    extL_arr = torch.where(arr_is_fw, eL, dbg.ext_map_rc(eR))
    node = j_rc + torch.where(arr_is_fw, 0, M)
    ok = (extL >= 0) & (extL_arr != dbg.FORK) & (node != M + idx) & valid
    succ_rc = torch.where(ok, node, -1)

    # fw start: no left extension, or the predecessor forks to the right
    eL, eR, _ = peek(pick(L["idx"], extL))
    pred_is_fw = pick(L["is_fw"], extL)
    extR_pred = torch.where(pred_is_fw, eR, dbg.ext_map_rc(eL))
    start_fw = ((extL < 0) | (extR_pred == dbg.FORK)) & valid

    # rc start: the predecessor is rc of the right candidate
    eL, eR, pal_j = peek(pick(R["idx"], extR))
    pred_is_fw = ~pick(R["is_fw"], extR) | pal_j
    extR_pred = torch.where(pred_is_fw, eR, dbg.ext_map_rc(eL))
    start_rc = ((extR < 0) | (extR_pred == dbg.FORK)) & valid

    last_nuc = torch.cat([bp.last_nuc(keys), 3 - bp.first_nuc(keys, k)])
    return (torch.cat([succ_fw, succ_rc]), torch.cat([start_fw, start_rc]),
            last_nuc)


def _doubling(succ: torch.Tensor):
    """Wyllie pointer doubling over the successor forest: (terminal node,
    steps to it, whether the chain terminates) per node."""
    n = succ.numel()
    nodes = torch.arange(n, dtype=torch.int64, device=succ.device)
    terminal = succ < 0
    ptr = torch.where(terminal, nodes, succ)
    dist = (~terminal).to(torch.int64)
    # exit once no pointer moves; cycles never settle, so the round cap
    # applies and their nodes end with reached = False
    rounds = max(1, int(np.ceil(np.log2(max(2, n)))) + 1)
    for _ in range(rounds):
        nptr = ptr[ptr]
        dist = dist + dist[ptr]
        moved = bool((nptr != ptr).any())
        ptr = nptr
        if not moved:
            break
    return ptr, dist, terminal[ptr]


def chain_structure(keys: torch.Tensor, k: int):
    """Successor function + list ranking over oriented k-mer nodes.

    Returns a dict of [2M] tensors: term, dist, reached, is_start,
    last_nuc (see metafast_tpu/graph/contigs.py chain_structure).

    The ranking is ``_doubling`` on every table.  The splitter walks
    (graph/rank.chain_rank), which the JAX package takes on its TPU from
    2^21 nodes, lose on the card: 0.0322-0.0575 s against 0.0053-0.0060 s
    on a sample's 4,996,448-node forest, and 0.0629-0.0802 s against
    0.0355-0.0373 s on the 25,981,764-node forest of the level-1 recount
    graph (chip_smoke.py phase "labels" (a), NVIDIA H100 80GB HBM3, 700 W,
    two runs): their 384-448 lockstep rounds cost a few launches each,
    where doubling takes at most 24 rounds of full-width gathers.

    Under a default mesh every rank holds the whole ``succ`` already, so
    each runs ``_doubling`` itself: the row-sharded ranking
    (parallel/contigs.sharded_doubling) would gather the same full
    result back to every rank, and is kept off this route.
    """
    t = dbg.neighbor_tables(keys, k)
    succ, is_start, last_nuc = _succ_from_tables(keys, t["left"],
                                                 t["right"], k)
    term, dist, reached = _doubling(succ)
    return dict(term=term, dist=dist, reached=reached, is_start=is_start,
                last_nuc=last_nuc)


def build_contigs(keys: torch.Tensor, counts: torch.Tensor, k: int,
                  len_threshold: int):
    """Contigs of a counted table (already filtered to count > b).

    keys: [M] sorted canonical int64 keys; counts: [M] int32, on one
    device.  Returns a list of (seq_str, avg_weight, min_weight,
    max_weight), ordered by start key.
    """
    M = keys.numel()
    if M == 0:
        return []
    with trace.span("contigs.chain"):
        st = chain_structure(keys, k)
        st["last_nuc"] = st["last_nuc"].to(torch.uint8)
    with trace.span("contigs.to_host"):
        trace.d2h(*st.values(), keys, counts)
        st = {name: v.cpu().numpy() for name, v in st.items()}
        keys64 = keys.cpu().numpy()
        counts = counts.cpu().numpy()
    with trace.span("contigs.assemble"):
        return _assemble(keys64, counts, k, len_threshold, M, st)


def _assemble(keys64, counts, k, len_threshold, M, st):
    """Host assembly of the ranked chains (metafast_tpu/graph/contigs.py
    :280-350)."""
    term = st["term"]
    dist = st["dist"]
    reached = st["reached"]
    last_nuc = st["last_nuc"]

    starts = np.nonzero(st["is_start"] & reached)[0]
    if len(starts) == 0:
        return []

    # palindromic keys make the fw and rc nodes identical: keep one chain
    _, first = np.unique(term[starts], return_index=True)
    starts = starts[np.sort(first)]

    seq_len = k + dist[starts]
    st_key = keys64[starts % M]
    end_key = keys64[term[starts] % M]

    emit = seq_len >= len_threshold
    emit &= (st_key < end_key) | (
        (st_key == end_key) & ((dist[starts] > 0) | (starts < M)))
    starts = starts[emit]
    if len(starts) == 0:
        return []
    seq_len = seq_len[emit]

    order = np.argsort(keys64[starts % M], kind="stable")
    starts = starts[order]
    seq_len = seq_len[order]

    n_chain = len(starts)
    terminals = term[starts]
    row_of = np.full(2 * M, -1, dtype=np.int64)
    row_of[terminals] = np.arange(n_chain)

    # per-chain stats over member nodes
    member = reached & (row_of[term] >= 0)
    nodes = np.nonzero(member)[0]
    rows = row_of[term[nodes]]
    ncounts = counts[(nodes % M)].astype(np.int64)
    wsum = np.zeros(n_chain, dtype=np.int64)
    wmin = np.full(n_chain, np.iinfo(np.int64).max, dtype=np.int64)
    wmax = np.zeros(n_chain, dtype=np.int64)
    np.add.at(wsum, rows, ncounts)
    np.minimum.at(wmin, rows, ncounts)
    np.maximum.at(wmax, rows, ncounts)

    # char buffer: node at step c of its chain writes char k-1+c
    offsets = np.zeros(n_chain + 1, dtype=np.int64)
    np.cumsum(seq_len, out=offsets[1:])
    buf = np.zeros(offsets[-1], dtype=np.uint8)
    cols = dist[starts][rows] - dist[nodes]
    buf[offsets[rows] + (k - 1) + cols] = CHARS[last_nuc[nodes]]

    # start prefixes: first k-1 chars of the oriented start k-mer
    out = []
    for r in range(n_chain):
        o = starts[r]
        key = int(keys64[o % M])
        val = key if o < M else rc64(key, k)
        s = buf[offsets[r]: offsets[r + 1]]
        s[: k - 1] = np.frombuffer(kmer_string(val, k)[: k - 1].encode(),
                                   dtype=np.uint8)
        n_kmers = int(seq_len[r]) - k + 1
        out.append((s.tobytes().decode("ascii"), int(wsum[r] // n_kmers),
                    int(wmin[r]), int(wmax[r])))
    return out

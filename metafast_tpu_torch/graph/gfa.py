"""Component -> unitig graph -> GFA v1.

Parity: src/algo/Comp2Graph.java (non-branching path merge over doubled
nodes), src/io/GFAWriter.java (S lines with LN:i:/KC:i:, L lines with
(k-1)M overlap).  Note the reference canonicalizes k-mers here by
*lexicographic string* comparison (GFAWriter.normalizeDna), which differs
from the numeric canonical used elsewhere — kept as-is for format parity.
"""

from __future__ import annotations

from ..utils.kmers import kmers_strings

_COMP = str.maketrans("ACGT", "TGCA")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def normalize_dna(s: str) -> str:
    rc = revcomp(s)
    return s if s < rc else rc


class _Node:
    __slots__ = ("seq", "id", "deleted", "rc", "neighbors")

    def __init__(self, seq: str, id_: int):
        self.seq = seq
        self.id = id_
        self.deleted = False
        self.rc: "_Node" = None
        self.neighbors: list["_Node"] = []


def component_gfa(kmers, weights, k: int, comp_id: int) -> str:
    """GFA text of one component.

    kmers: int64 canonical keys; weights: per-k-mer coverage values
    aligned with kmers (all 1 when no coverage source).
    """
    strings = kmers_strings(kmers, k)
    cover = {}
    for s, w in zip(strings, weights):
        cover[normalize_dna(s)] = int(w)

    # doubled-node graph: one node per orientation of each unique k-mer
    nodes: list[_Node] = []
    for seq in cover:
        a = _Node(seq, len(nodes))
        b = _Node(revcomp(seq), len(nodes))
        a.rc, b.rc = b, a
        nodes.extend([a, b])

    by_prefix: dict[str, list[_Node]] = {}
    for n in nodes:
        by_prefix.setdefault(n.seq[: k - 1], []).append(n)
    for n in nodes:
        suffix = n.seq[1:]
        if suffix in by_prefix:
            n.rc.neighbors.extend(by_prefix[suffix])

    # merge non-branching paths (Comp2Graph.mergePaths/mergeNodes)
    acted = True
    while acted:
        acted = False
        for n in nodes:
            if n.deleted or len(n.neighbors) != 1:
                continue
            other = n.neighbors[0]
            if len(other.neighbors) != 1:
                continue
            first_minus, second_plus = n.rc, other.rc
            assert second_plus.seq[-(k - 1):] == n.seq[: k - 1]
            new_seq = second_plus.seq + n.seq[k - 1:]
            new_rc = first_minus.seq + other.seq[k - 1:]
            second_plus.seq = new_seq
            first_minus.seq = new_rc
            second_plus.rc = first_minus
            first_minus.rc = second_plus
            n.deleted = other.deleted = True
            acted = True

    def node_id(n: _Node) -> str:
        return f"{min(n.id, n.rc.id) + 1}_i{comp_id}"

    out = []
    for n in nodes:
        if not n.deleted and n.seq <= n.rc.seq:
            coverage = 0
            for i in range(len(n.seq) - k + 1):
                coverage += cover[normalize_dna(n.seq[i:i + k])]
            coverage += cover[normalize_dna(n.seq[-k:])] * (k - 1)
            out.append(f"S\t{node_id(n)}\t{n.seq}\tLN:i:{len(n.seq)}"
                       f"\tKC:i:{coverage}")
    for n in nodes:
        if n.deleted:
            continue
        for j in n.neighbors:
            if j.deleted:
                continue
            o1 = "+" if n.seq >= n.rc.seq else "-"
            o2 = "+" if j.seq <= j.rc.seq else "-"
            out.append(f"L\t{node_id(n)}\t{o1}\t{node_id(j)}\t{o2}\t{k - 1}M")
    return "\n".join(out) + ("\n" if out else "")

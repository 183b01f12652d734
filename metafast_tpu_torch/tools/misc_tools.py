"""Auxiliary tools: component-paths, comparison-script,
antibody-sequences-finder, supergraph-sequence-builder.

Parity: src/tools/ComponentPathsMain.java, CompareReadsAndComponentsMain.java,
AntibodyFinderMain.java, SupergraphSeqBuilderMain.java (the latter is
marked "NOT COMPLETED" in the reference TOOLS registry).

Counterpart of metafast_tpu/tools/misc_tools.py (:26-326).  Reads are
counted on ``ctx.device``, and the supergraph table is built and its
contigs assembled there; the path and coverage scans and the antibody
walk stay on the host, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import api
from ..graph import contigs as contigs_mod
from ..io import binfmt, textfmt
from ..io import reads as readsio
from ..ops.count import SATURATE
from ..utils.kmers import kmer_string, rc64, sequence_kmers
from .framework import ExecutionFailed, Param, Tool, host, register

MAX_PATHS_COUNT = int(1e6)


@register
class ComponentPathsTool(Tool):
    NAME = "component-paths"
    DESCRIPTION = "Extracts paths in the components"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("components-file", Path, "cf", mandatory=True,
              description="binary file with connected components"),
        Param("seq", Path, mandatory=True, multiple=True,
              description="files with paths (sequences)"),
        Param("components", int, "cm", multiple=True,
              description="components' numbers to print paths for"),
        Param("all-components", bool, "a", default=False,
              description="print paths for all components"),
        Param("min-length", int, "l", default=50,
              description="minimum path length to be printed"),
        Param("output-dir", Path, "o",
              default=lambda t: (t.workdir or Path(".")) / "paths",
              description="Destination of resulting FASTA sequences"),
    ]

    def run_impl(self):
        k = self.get("k")
        comps = binfmt.read_components_bin(str(self.get("components-file")))
        self.info(f"{len(comps)} components loaded")
        if self.get("all-components"):
            numbers = list(range(1, len(comps) + 1))
        else:
            numbers = list(self.get("components") or [])
            if not numbers:
                raise ExecutionFailed(
                    "No components to process!!! Do you forget to set "
                    "--all-components or --components n1 n2 ...?")

        comp_sets = []
        for no in numbers:
            kmers, weight = comps[no - 1]
            comp_sets.append((no, np.sort(kmers),
                              weight / max(len(kmers), 1)))

        paths: dict[int, list[tuple[str, int]]] = {no: [] for no in numbers}
        min_len = self.get("min-length")
        for f in self.get("seq"):
            self.info(f"Loading file {Path(f).name}...")
            for seq in readsio.iter_reads(str(f)):
                kk = sequence_kmers(seq, k)
                if len(kk) == 0:
                    continue
                for no, keys, avg_w in comp_sets:
                    idx = np.searchsorted(keys, kk)
                    idx = np.clip(idx, 0, max(len(keys) - 1, 0))
                    inside = keys[idx] == kk
                    # maximal runs of consecutive in-component k-mers
                    # (ComponentPathsMain.java:134-157)
                    padded = np.r_[False, inside, False]
                    starts = np.nonzero(padded[1:] & ~padded[:-1])[0]
                    ends = np.nonzero(~padded[1:] & padded[:-1])[0]
                    for s, e in zip(starts, ends):
                        length = e - s - 1 + k
                        if length >= min_len and \
                                len(paths[no]) < MAX_PATHS_COUNT:
                            paths[no].append(
                                (seq[s:s + length], int(round(avg_w))))

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        for no in numbers:
            seqs = sorted(paths[no], key=lambda t: -len(t[0]))
            fp = out_dir / f"component-{no}.seq.fasta"
            textfmt.write_contigs_fasta(
                str(fp), [(s, w, 0, 0) for s, w in seqs])
        self.info(f"Paths for {len(numbers)} component(s) were saved in "
                  f"directory {out_dir}")
        self.set_output("output-dir", str(out_dir))


@register
class CompareReadsComponentsTool(Tool):
    NAME = "comparison-script"
    DESCRIPTION = ("Statistics: reference positions vs components vs mapped "
                   "reads coverage")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("components-file", Path, "cf", mandatory=True,
              description="file with connected components in binary format"),
        Param("reference-file", Path, "r", mandatory=True,
              description="FASTA file with reference"),
        Param("samtools-file", Path, "so", mandatory=True,
              description="SamTools view reads output from BAM file"),
    ]

    def run_impl(self):
        k = self.get("k")
        comps = binfmt.read_components_bin(str(self.get("components-file")))

        contigs = {}    # id -> sequence
        order = []
        cur_id, cur = None, []
        for line in open(self.get("reference-file")):
            line = line.rstrip("\n")
            if line.startswith(">"):
                if cur_id is not None:
                    contigs[cur_id] = "".join(cur)
                cur_id = line[1:]
                order.append(cur_id)
                cur = []
            else:
                cur.append(line)
        if cur_id is not None:
            contigs[cur_id] = "".join(cur)

        begins = {cid: np.zeros(len(s) + 1, dtype=np.int64)
                  for cid, s in contigs.items()}
        ends = {cid: np.zeros(len(s) + 1, dtype=np.int64)
                for cid, s in contigs.items()}
        for line in open(self.get("samtools-file")):
            parts = line.split()
            if len(parts) < 6:
                continue
            cid, pos, cigar = parts[2], int(parts[3]), parts[5]
            if cid not in contigs:
                continue
            read_len = int(cigar[:-1])
            begins[cid][pos] += 1
            ends[cid][min(pos + read_len - 1, len(ends[cid]) - 1)] += 1

        # k-mer -> 1-based component number
        all_keys = []
        all_nos = []
        for i, (kmers, _w) in enumerate(comps):
            all_keys.append(np.sort(kmers))
            all_nos.append(np.full(len(kmers), i + 1, dtype=np.int64))
        if all_keys:
            ck = np.concatenate(all_keys)
            cn = np.concatenate(all_nos)
            o = np.argsort(ck)
            ck, cn = ck[o], cn[o]
        else:
            ck = np.empty(0, dtype=np.int64)
            cn = np.empty(0, dtype=np.int64)

        comp_count = np.zeros(len(comps) + 1, dtype=np.int64)
        in_reads = in_comps = in_both = 0
        out_fp = self.workdir / "reference-to-component"
        with open(out_fp, "w") as pw:
            for cid in order:
                pw.write(cid + "\n")
                seq = contigs[cid]
                kk = sequence_kmers(seq, k)
                if len(kk):
                    idx = np.searchsorted(ck, kk)
                    idx = np.clip(idx, 0, max(len(ck) - 1, 0))
                    comp_no = np.where(ck[idx] == kk, cn[idx], 0) \
                        if len(ck) else np.zeros(len(kk), dtype=np.int64)
                else:
                    comp_no = np.empty(0, dtype=np.int64)
                cover = np.cumsum(begins[cid][:-1]) \
                    - np.r_[0, np.cumsum(ends[cid][:-2])]
                for p, no in enumerate(comp_no):
                    reads_here = int(cover[p + k - 1]) if p + k - 1 < len(cover) else 0
                    pw.write(f"{p} {no} {reads_here}\n")
                    comp_count[no] += 1
                    if no > 0 and reads_here > 0:
                        in_both += 1
                    elif no > 0:
                        in_comps += 1
                    elif reads_here > 0:
                        in_reads += 1
        self.info(f"just in reads = {in_reads}")
        self.info(f"just in components = {in_comps}")
        self.info(f"in components and reads = {in_both}")
        with open(self.workdir / "components-stat", "w") as fh:
            for i, c in enumerate(comp_count):
                if c > 0:
                    fh.write(f"{i} {c}\n")
        self.set_output("output-file", str(out_fp))


@register
class AntibodyFinderTool(Tool):
    NAME = "antibody-sequences-finder"
    DESCRIPTION = "Antibody sequences finder in De Bruijn graph"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("shift", int, default=50, description="shift from the start"),
        Param("max-distance", int, "d", mandatory=True,
              description="distance from constant fragment"),
        Param("fragment-file", Path, "ff", mandatory=True,
              description="file with constant fragment in FASTA"),
        Param("reads", Path, "i", mandatory=True, multiple=True,
              description="list of input read files"),
        Param("maximal-bad-frequency", int, "b", mandatory=True,
              description="maximal frequency for an erroneous k-mer"),
    ]

    def run_impl(self):
        k = self.get("k")
        b = self.get("maximal-bad-frequency")
        frag = "".join(s for s in readsio.iter_reads(
            str(self.get("fragment-file"))))
        self.info(f"Constant fragment length = {len(frag)}")

        keys, counts, _ = api.count_reads_files(
            [str(f) for f in self.get("reads")], k, self.device)
        table = dict(zip(host(keys).tolist(), host(counts).tolist()))

        # boost constant-fragment k-mers above the threshold
        # (AntibodyFinderMain.java:94-103)
        frag_kmers = sequence_kmers(frag, k)
        for kk in frag_kmers[1:]:
            table[int(kk)] = min(table.get(int(kk), 0) + b + 1, 32767)

        shift = self.get("shift")
        start_fw = 0
        for ch in frag[shift:shift + k]:
            start_fw = (start_fw << 2) | "AGCT".index(ch)
        depth = self.get("max-distance") + shift

        # BFS leftward in oriented (fw) space (AntibodyFinderMain.java:107-149)
        dist = {start_fw: 1}
        queue = [start_fw]
        unique = np.zeros(depth + 2, dtype=np.int64)
        total = np.zeros(depth + 2, dtype=np.int64)
        lines: dict[int, list[str]] = {}
        while queue:
            fw = queue.pop(0)
            d = dist[fw]
            if d > depth:
                break
            canon = min(fw, rc64(fw, k))
            lines.setdefault(d, []).append(kmer_string(fw, k))
            unique[d] += 1
            total[d] += table.get(canon, 0)
            for nuc in range(4):
                nfw = (fw >> 2) | (nuc << (2 * (k - 1)))
                ncanon = min(nfw, rc64(nfw, k))
                if nfw not in dist and table.get(ncanon, 0) > b:
                    dist[nfw] = d + 1
                    queue.append(nfw)

        with open(self.workdir / "kmers", "w") as fh:
            for d in sorted(lines):
                fh.write(" ".join(lines[d]) + " \n")
        with open(self.workdir / f"stat-b{b}", "w") as fh:
            for i in range(depth + 1):
                fh.write(f"{i} {unique[i]} {total[i]}\n")
        self.set_output("stat-file", str(self.workdir / f"stat-b{b}"))


@register
class SupergraphSeqBuilderTool(Tool):
    NAME = "supergraph-sequence-builder"
    DESCRIPTION = ("Build sequences from the multi-sample supergraph "
                   "(reference marks this tool NOT COMPLETED)")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("reads", Path, "i", mandatory=True, multiple=True,
              description="list of read files (one sample each)"),
        Param("maximal-bad-frequency", int, "b",
              description="per-sample maximal erroneous k-mer frequency"),
        Param("bottom-cut-percent", int, "bp",
              description="per-sample percent of k-mers assumed erroneous"),
        Param("supergraph-frequency", int, "sb", mandatory=True,
              description="maximal erroneous k-mer frequency in supergraph"),
        Param("sequence-len", int, "l", mandatory=True,
              description="minimal sequence length to be written"),
    ]

    def run_impl(self):
        k = self.get("k")
        dev = self.device
        # per key, the number of samples holding it above their b,
        # saturating like the reference's short values
        super_keys = torch.empty(0, dtype=torch.int64, device=dev)
        super_vals = torch.empty(0, dtype=torch.int64, device=dev)
        for f in self.get("reads"):
            keys, counts, _ = api.count_reads_files([str(f)], k, dev)
            b = self.get("maximal-bad-frequency")
            if b is None and self.get("bottom-cut-percent") is not None:
                total = int(counts.sum())
                to_cut = total * self.get("bottom-cut-percent") // 100
                hist = torch.bincount(counts.clamp(max=1023)).tolist()
                cur, b = 0, 1
                for i in range(len(hist) - 1):
                    if cur >= to_cut:
                        b = i
                        break
                    cur += i * hist[i]
            elif b is None:
                b = 1
            good = keys[counts > b]
            super_keys, inv = torch.unique(torch.cat([super_keys, good]),
                                           return_inverse=True)
            super_vals = torch.zeros_like(super_keys).index_add_(
                0, inv, torch.cat([super_vals, torch.ones_like(good)])
            ).clamp_(max=SATURATE)

        sb = self.get("supergraph-frequency")
        keep = super_vals > sb
        seqs = contigs_mod.build_contigs(super_keys[keep],
                                         super_vals[keep].to(torch.int32), k,
                                         self.get("sequence-len"))
        out = self.workdir / "sequences.fasta"
        textfmt.write_contigs_fasta(str(out), seqs)
        self.info(f"{len(seqs)} sequences written to {out}")
        self.set_output("output-file", str(out))

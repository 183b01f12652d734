"""Converter tools: view, double-view, bin2fasta, seq2comp, comp2seq.

Counterpart of metafast_tpu/tools/convert.py (:30-254); parity:
src/tools/ViewMain.java, DoubleViewMain.java, BinaryToFasta.java,
SequencesToComponents.java, ComponentsToSequences.java.  These tools are
file formatting on the host, as in the JAX package, apart from
double-view's join (on ``ctx.device``) and the counting and contig steps
of comp2seq.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from metafast_tpu.io import binfmt
from metafast_tpu.io import reads as readsio
from metafast_tpu.utils.kmers import kmers_strings, sequence_kmers

from ..graph.lookup import values_at
from .framework import Param, Tool, host, late_bind, read_table, register
from .pipeline1 import KmerCounterManyTool, SeqBuilderManyTool


def _open_out(path):
    if path is None:
        return sys.stdout, False
    p = Path(path)
    if p.parent:
        p.parent.mkdir(parents=True, exist_ok=True)
    return open(p, "w"), True


@register
class ViewTool(Tool):
    NAME = "view"
    DESCRIPTION = "Converts different binary objects to text format"
    PARAMS = [
        Param("k", int, "k", default=31,
              description="k-mer size, used while saving object"),
        Param("kmers-file", Path, "kf", description="binary file with kmers"),
        Param("components-file", Path, "cf",
              description="binary components file"),
        Param("output-file", Path, "o", default_comment="print to the screen",
              description="file to print to"),
        Param("long", bool, default=False,
              description="k-mers values are stored in 'long'"),
    ]

    def run_impl(self):
        k = self.get("k")
        if not self.get("kmers-file") and not self.get("components-file"):
            self.warn("No input file is selected  --->  no data to display!")
            return
        out, close = _open_out(self.get("output-file"))
        try:
            if self.get("kmers-file"):
                if self.get("long"):
                    keys, vals = binfmt.read_long_kmers_bin(
                        str(self.get("kmers-file")))
                else:
                    keys, vals = binfmt.read_kmers_bin(
                        str(self.get("kmers-file")))
                out.write("Kmer\tCount\n")
                for s, v in zip(kmers_strings(keys, k), vals):
                    out.write(f"{s}\t{int(v)}\n")
            if self.get("components-file"):
                comps = binfmt.read_components_bin(
                    str(self.get("components-file")))
                self.info(f"{len(comps)} components loaded")
                out.write(f"{len(comps)} components:\n")
                for i, (kmers, weight) in enumerate(comps):
                    out.write(f"Component {i + 1}, size = {len(kmers)} kmers, "
                              f"weight = {weight}. Kmers:\n")
                    for s in kmers_strings(kmers, k):
                        out.write(s + "\n")
                    out.write("\n")
        finally:
            if close:
                out.close()
        if self.get("output-file"):
            self.set_output("output-file", str(self.get("output-file")))


@register
class DoubleViewTool(Tool):
    NAME = "double-view"
    DESCRIPTION = "Prints k-mers from two binary files to text file"
    PARAMS = [
        Param("k", int, "k", default=31, description="k-mer size"),
        Param("kmers-mgx", Path, "mgx", mandatory=True,
              description="first binary file with k-mers"),
        Param("kmers-mtx", Path, "mtx", mandatory=True,
              description="second binary file with k-mers"),
        Param("output-file", Path, "o", default_comment="print to the screen",
              description="file to print to"),
    ]

    def run_impl(self):
        k = self.get("k")
        dev = self.device
        mtx_k, mtx_v = read_table(self.get("kmers-mtx"), dev)
        mgx_k, mgx_v = read_table(self.get("kmers-mgx"), dev)
        mgx_k, order = torch.sort(mgx_k, stable=True)
        other = values_at(mgx_k, mgx_v[order], mtx_k)

        out, close = _open_out(self.get("output-file"))
        try:
            out.write("Kmer\tmtx_count\tmgx_count\n")
            for s, v, o in zip(kmers_strings(host(mtx_k), k),
                               host(mtx_v).tolist(), host(other).tolist()):
                out.write(f"{s}\t{v}\t{o}\n")
        finally:
            if close:
                out.close()


@register
class BinaryToFastaTool(Tool):
    NAME = "bin2fasta"
    DESCRIPTION = "Converts different binary objects to FASTA format"
    PARAMS = [
        Param("k", int, "k", default=31, description="k-mer size"),
        Param("kmers-file", Path, "kf", description="binary file with kmers"),
        Param("components-file", Path, "cf",
              description="binary components file"),
        Param("split", bool, default=False,
              description="save each component in separate file"),
        Param("output-file", Path, "o", default_comment="print to the screen",
              description="file prefix to print to"),
    ]

    def run_impl(self):
        k = self.get("k")
        prefix = self.get("output-file")
        if not self.get("kmers-file") and not self.get("components-file"):
            self.warn("No input file is selected  --->  no data to display!")
            return
        out_files = []
        if self.get("kmers-file"):
            keys, _ = binfmt.read_kmers_bin(str(self.get("kmers-file")))
            out, close = _open_out(f"{prefix}.fasta" if prefix else None)
            try:
                for i, s in enumerate(kmers_strings(keys, k), start=1):
                    out.write(f">{i}\n{s}\n")
            finally:
                if close:
                    out.close()
            if prefix:
                out_files.append(f"{prefix}.fasta")
        if self.get("components-file"):
            comps = binfmt.read_components_bin(
                str(self.get("components-file")))
            self.info(f"Printing {len(comps)} components...")
            if self.get("split"):
                for i, (kmers, _w) in enumerate(comps, start=1):
                    fp = f"{prefix}_{i}.fasta" if prefix else None
                    out, close = _open_out(fp)
                    try:
                        for j, s in enumerate(kmers_strings(kmers, k),
                                              start=1):
                            out.write(f">{j}\n{s}\n")
                    finally:
                        if close:
                            out.close()
                    if fp:
                        out_files.append(fp)
            else:
                fp = f"{prefix}.fasta" if prefix else None
                out, close = _open_out(fp)
                try:
                    n = 1
                    for kmers, _w in comps:
                        for s in kmers_strings(kmers, k):
                            out.write(f">{n}\n{s}\n")
                            n += 1
                finally:
                    if close:
                        out.close()
                if fp:
                    out_files.append(fp)
        self.set_output("resulting-kmers-files", out_files)


@register
class SequencesToComponentsTool(Tool):
    NAME = "seq2comp"
    DESCRIPTION = "Transforms sequences to components"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("sequences", Path, "i", mandatory=True, multiple=True,
              description="list of input files"),
        Param("components-file", Path,
              default=lambda t: (t.workdir or Path(".")) / "components.bin",
              description="file to write found components to"),
    ]

    def run_impl(self):
        k = self.get("k")
        comps = []
        for f in self.get("sequences"):
            before = len(comps)
            for seq in readsio.iter_reads(str(f)):
                kk = sequence_kmers(seq, k)
                if len(kk) == 0:
                    continue
                # weight counts every k-mer occurrence
                # (SequenceComponent.add, src/structures/SequenceComponent.java:36-41)
                comps.append((np.unique(kk), len(kk)))
            self.info(f"{len(comps) - before} components added from {f}")
        out = self.get("components-file")
        out.parent.mkdir(parents=True, exist_ok=True)
        binfmt.write_components_bin(str(out), comps)
        self.info(f"{len(comps)} components saved to {out}")
        self.set_output("components-file", str(out))


@register
class ComponentsToSequencesTool(Tool):
    NAME = "comp2seq"
    DESCRIPTION = "Transforms components to sequences"
    PARAMS = [
        Param("k", int, "k", default=31, description="k-mer size"),
        Param("components-file", Path, "cf", mandatory=True,
              description="binary components file"),
        Param("split", bool, default=False,
              description="save each component in separate file"),
    ]

    def run_impl(self):
        b2f = BinaryToFastaTool()
        b2f.set("k", self.get("k"))
        b2f.set("components-file", self.get("components-file"))
        b2f.set("split", self.get("split"))
        b2f.set("output-file", self.workdir / "kmers_fasta" / "component")
        self.add_step(b2f)

        counter = KmerCounterManyTool()
        counter.set("k", self.get("k"))
        counter.set("maximal-bad-frequency", 0)
        late_bind(counter, "reads",
                  lambda: b2f.outputs["resulting-kmers-files"])
        self.add_step(counter)

        builder = SeqBuilderManyTool()
        builder.set("k", self.get("k"))
        builder.set("maximal-bad-frequency", 0)
        builder.set("sequence-len", self.get("k"))
        late_bind(builder, "k-mers",
                  lambda: counter.outputs["resulting-kmers-files"])
        self.add_step(builder)

"""Pipeline 1 tools: the default distance-matrix chain, on ``ctx.device``.

Counterpart of metafast_tpu/tools/pipeline1.py (:30-379); parity targets
(src/tools/): KmersCounterMain, KmersCounterForManyFilesMain,
SeqBuilderMain, SeqBuilderForManyFilesMain, ComponentCutterMain,
FeaturesCalculatorMain, DistanceMatrixCalculatorMain.  Tables, contigs'
k-mers, components and feature vectors stay on the device; they come to
the host only to be written.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .. import api
from ..graph import components as comp_mod
from ..graph import contigs as contigs_mod
from ..io import binfmt, textfmt
from ..io import reads as readsio
from ..pipeline.matrix import (bray_curtis_matrix, count_contig_kmers,
                               feature_vectors)
from ..utils import trace
from ..utils.progress import CountingProgress
from .framework import (ExecutionFailed, Param, Tool, check_k, host,
                        read_table, register, workdir_sub)


@register
class KmerCounterTool(Tool):
    NAME = "kmer-counter"
    DESCRIPTION = "Count k-mers in given reads"
    PARAMS = [
        Param("k", int, "k", mandatory=True,
              description="k-mer size (maximum 31 due to realization details)"),
        Param("reads", Path, "i", mandatory=True, multiple=True,
              description="list of reads files from single environment. "
                          "FASTQ, FASTA (ignored reads with 'N')"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for a k-mer to be assumed erroneous"),
        Param("output-dir", Path, default=workdir_sub("kmers"),
              description="Output directory"),
        Param("stats-dir", Path, default=workdir_sub("stats"),
              description="Directory with statistics"),
    ]

    def run_impl(self):
        k = self.get("k")
        check_k(k)
        files = [str(f) for f in self.get("reads")]
        b = self.get("maximal-bad-frequency")

        with CountingProgress(logger=self.ctx.logger) as prog:
            keys, counts, stats = api.count_reads_files(
                files, k, self.device, progress=prog)
        self.info(f"{len(keys)} k-mers found over {stats['reads']} reads "
                  f"({stats['skipped']} skipped)")
        if stats.get("spills"):
            self.warn(f"the k-mer table reached the card's spill threshold "
                      f"and moved to host RAM {stats['spills']} time(s); "
                      f"it was merged on the host (slow)")

        out_dir = self.get("output-dir")
        st_dir = self.get("stats-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        st_dir.mkdir(parents=True, exist_ok=True)
        name = readsio.sample_name(files)
        out_file = out_dir / f"{name}.kmers.bin"
        st_file = st_dir / f"{name}.stat.txt"

        good = counts > b
        with trace.span("count.to_host"):
            good_keys, good_counts = host(keys[good]), host(counts[good])
            stat = textfmt.frequency_histogram(counts)
        with trace.span("write.kmers_bin", out_file):
            binfmt.write_kmers_bin(str(out_file), good_keys, good_counts)
        with trace.span("write.stat", st_file):
            textfmt.write_histogram(str(st_file), *stat)
        n_good = len(good_keys)
        self.info(f"{n_good} of them is good (not erroneous)")
        if len(keys) == 0:
            self.warn("No k-mers found in reads!")
        elif n_good == 0 or n_good < len(keys) * 0.03:
            self.warn("Too few good k-mers were found! Perhaps you should "
                      "decrease k-mer size or --maximal-bad-frequency value")
        self.set_output("resulting-kmers-file", str(out_file))
        self.set_output("stat-file", str(st_file))
        self.describe_output(out_file, f"File with good (non-erroneous) k-mers "
                                       f"of library {name}")


@register
class KmerCounterManyTool(Tool):
    NAME = "kmer-counter-many"
    DESCRIPTION = "Count k-mers in given reads files (many samples)"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("reads", Path, "i", mandatory=True, multiple=True,
              description="list of reads files (all samples)"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
        Param("stats-dir", Path, default=workdir_sub("stats")),
    ]

    def run_impl(self):
        groups = readsio.sort_and_pair([str(f) for f in self.get("reads")])
        self.info(f"{len(groups)} libraries to process")
        self._counters = []
        for g in groups:
            c = KmerCounterTool()
            c.set("k", self.get("k"))
            c.set("reads", g)
            c.set("maximal-bad-frequency", self.get("maximal-bad-frequency"))
            c.set("output-dir", self.get("output-dir"))
            c.set("stats-dir", self.get("stats-dir"))
            self.add_step(c)
            self._counters.append(c)

    def run(self, ctx, workdir=None):
        super().run(ctx, workdir)
        self.set_output("resulting-kmers-files",
                        [c.outputs["resulting-kmers-file"]
                         for c in self._counters])


@register
class SeqBuilderTool(Tool):
    NAME = "seq-builder"
    DESCRIPTION = "Metagenome De Bruijn graph analysis and sequences building"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="list of input files with k-mers in binary format"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("bottom-cut-percent", int,
              description="k-mers percent to be assumed erroneous (overrides -b)"),
        Param("sequence-len", int, "l", mandatory=True,
              description="minimal sequence length to be written"),
        Param("output-dir", Path, "o", default=workdir_sub("sequences"),
              description="Destination of resulting FASTA sequences"),
    ]

    def run_impl(self):
        k = self.get("k")
        b = self.get("maximal-bad-frequency")
        files = [str(f) for f in self.get("k-mers")]
        with trace.span("contigs.load"):
            keys, counts = api.load_kmers_bin(files, b, self.device)

        # frequency histogram -> distribution file (SeqBuilderMain.java:84-101)
        dist_file = self.workdir / "distribution"
        with trace.span("contigs.to_host"):
            host_counts = host(counts)
        with trace.span("write.distribution", dist_file):
            stat = textfmt.write_distribution(str(dist_file), host_counts)

        bp_pct = self.get("bottom-cut-percent")
        if bp_pct is not None:
            total = int(counts.sum())
            to_cut = total * bp_pct // 100
            cur = 0
            for i in range(len(stat) - 1):
                if cur >= to_cut:
                    b = i
                    break
                cur += i * int(stat[i])
            self.info(f"Using bottom cut percent = {bp_pct} -> b = {b}")
            keep = counts > b
            keys, counts = keys[keep], counts[keep]
        self.info(f"Using maximal bad frequency = {b}")

        seqs = contigs_mod.build_contigs(keys, counts, k,
                                         self.get("sequence-len"))
        self.info(f"{len(seqs)} sequences found")
        if not seqs:
            self.warn("No sequences were found! Perhaps you should decrease "
                      "--min-seq-len or --maximal-bad-frequency values")

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        base = Path(files[0]).name
        base = base[:-len(".kmers.bin")] if base.endswith(".kmers.bin") else base
        fp = out_dir / (base + ("+" if len(files) > 1 else "") + ".seq.fasta")
        with trace.span("write.fasta", fp):
            textfmt.write_contigs_fasta(str(fp), seqs)
        self.info(f"Sequences printed to {fp}")
        self.set_output("output-file", str(fp))


@register
class SeqBuilderManyTool(Tool):
    NAME = "seq-builder-many"
    DESCRIPTION = "Build sequences for many k-mer files"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="list of input files with k-mers in binary format"),
        Param("maximal-bad-frequency", int, "b", default=1),
        Param("bottom-cut-percent", int),
        Param("sequence-len", int, "l", mandatory=True),
        Param("output-dir", Path, "o", default=workdir_sub("sequences")),
    ]

    def run_impl(self):
        if (self.values.get("maximal-bad-frequency") is not None
                and self.get("bottom-cut-percent") is not None):
            raise ExecutionFailed("-b and -bp can not be set both")
        self._builders = []
        for f in self.get("k-mers"):
            sb = SeqBuilderTool()
            sb.set("k", self.get("k"))
            sb.set("k-mers", [f])
            sb.set("maximal-bad-frequency", self.get("maximal-bad-frequency"))
            if self.get("bottom-cut-percent") is not None:
                sb.set("bottom-cut-percent", self.get("bottom-cut-percent"))
            sb.set("sequence-len", self.get("sequence-len"))
            sb.set("output-dir", self.get("output-dir"))
            self.add_step(sb)
            self._builders.append(sb)

    def run(self, ctx, workdir=None):
        super().run(ctx, workdir)
        self.set_output("output-files",
                        [b.outputs["output-file"] for b in self._builders])


@register
class ComponentCutterTool(Tool):
    NAME = "component-cutter"
    DESCRIPTION = "Build graph components from tangled graph"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("min-seq-len", int, "l", default=100,
              description="minimum sequence length to be added"),
        Param("min-component-size", int, "b1", default=1000,
              description="minimum component size (in k-mers)"),
        Param("max-component-size", int, "b2", default=10000,
              description="maximum component size (in k-mers)"),
        Param("sequences", Path, "i", mandatory=True, multiple=True,
              description="list of input FASTA files"),
        Param("components-file", Path,
              default=lambda t: (t.workdir or Path(".")) / "components.bin",
              description="file to write found components to"),
    ]

    def run_impl(self):
        k = self.get("k")
        seqs: list[str] = []
        for f in self.get("sequences"):
            with trace.span("read.fasta"):
                seqs.extend(readsio.iter_reads(str(f)))
        with trace.span("components.recount"):
            gkeys, gcounts = count_contig_kmers(
                seqs, k, self.device, min_len=self.get("min-seq-len"))
        if gkeys.numel() == 0:
            raise ExecutionFailed("No sequences were found in input files!")
        comps = comp_mod.split_components(
            gkeys, gcounts, k,
            self.get("min-component-size"), self.get("max-component-size"))
        self.info(f"Total {len(comps)} components were found")
        if not comps:
            self.warn("No components were extracted! Perhaps you should "
                      "decrease --min-component-size value")

        out = self.get("components-file")
        out.parent.mkdir(parents=True, exist_ok=True)
        with trace.span("components.to_host"):
            members = list(zip(comp_mod.members_to_host(comps),
                               (c.weight for c in comps)))
        with trace.span("write.components", out):
            binfmt.write_components_bin(str(out), members)
        stat_fp = self.workdir / (
            f"components-stat-{self.get('min-component-size')}-"
            f"{self.get('max-component-size')}.txt")
        with trace.span("write.components_stat", stat_fp), \
                open(stat_fp, "w") as fh:
            fh.write("# component.no\tcomponent.size\tcomponent.weight"
                     "\tusedFreqThreshold\n")
            for i, c in enumerate(comps):
                fh.write(f"{i + 1}\t{c.size}\t{c.weight}"
                         f"\t{c.used_freq_threshold}\n")
        self.info(f"Components saved to {out}")
        self.set_output("components-file", str(out))
        self.set_output("components-stat", str(stat_fp))


@register
class FeaturesCalculatorTool(Tool):
    NAME = "features-calculator"
    DESCRIPTION = "Calculate features for samples"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("components", Path, "cm", mandatory=True,
              description="components file"),
        Param("k-mers", Path, "ka", multiple=True,
              description="k-mer files (one per sample)"),
        Param("reads", Path, "i", multiple=True,
              description="read files (alternative to --k-mers)"),
        Param("threshold", int, default=0,
              description="minimal frequency to count k-mer present"),
        Param("selected-kmers", Path, multiple=True,
              description="restrict features to these k-mers"),
    ]

    def run_impl(self):
        k = self.get("k")
        dev = self.device
        with trace.span("read.components"):
            loaded = binfmt.read_components_bin(str(self.get("components")))
        with trace.span("features.load"):
            trace.h2d(dev, *(kmers for kmers, _ in loaded))
            comps = [comp_mod.Component(
                         kmers=torch.sort(torch.from_numpy(kmers)
                                          .to(dev)).values,
                         weight=weight, used_freq_threshold=0)
                     for kmers, weight in loaded]
        if not comps:
            raise ExecutionFailed("No components were found in input file!")
        self.info(f"{len(comps)} components loaded")

        if self.get("selected-kmers"):
            with trace.span("features.select"):
                sel, _ = api.load_kmers_bin(
                    [str(f) for f in self.get("selected-kmers")], 0, dev)
                for c in comps:
                    c.kmers = c.kmers[torch.isin(c.kmers, sel)]

        out_dir = self.workdir / "vectors"
        out_dir.mkdir(parents=True, exist_ok=True)
        thr = self.get("threshold")
        features_files = []

        def tables():
            for f in (self.get("reads") or []):
                keys, counts, _ = api.count_reads_files([str(f)], k, dev)
                yield readsio.library_name(str(f)), keys, counts
            for f in (self.get("k-mers") or []):
                name = Path(f).name
                if name.endswith(".kmers.bin"):
                    name = name[:-len(".kmers.bin")]
                keys, counts = read_table(f, dev)
                keys, order = torch.sort(keys, stable=True)
                yield name, keys, counts[order]

        for name, keys, counts in tables():
            with trace.span("features.vectors"):
                vec, brd = feature_vectors(comps, keys, counts, thr)
            vf = out_dir / f"{name}.vec"
            bf = out_dir / f"{name}.breadth"
            with trace.span("features.to_host"):
                vec, brd = host(vec), host(brd)
            with trace.span("write.vec", vf, bf):
                textfmt.write_vector(str(vf), vec)
                textfmt.write_breadth(str(bf), brd)
            self.info(f"Features for {name} printed to {vf}")
            features_files.append(str(vf))

        self.set_output("features-files", features_files)
        self.set_output("vectors-dir", str(out_dir))


@register
class DistMatrixCalculatorTool(Tool):
    NAME = "dist-matrix-calculator"
    DESCRIPTION = "Calculate Bray-Curtis distance matrix from features"
    PARAMS = [
        Param("features", Path, "i", mandatory=True, multiple=True,
              description="feature vector files (.vec)"),
        Param("matrix-file", Path,
              default=lambda t: (t.workdir or Path(".")) / "dist_matrix.txt",
              description="resulting distance matrix file"),
        Param("without-header", bool, default=False,
              description="do not write the #\\tname header line"),
    ]

    def run_impl(self):
        files = [str(f) for f in self.get("features")]
        names = []
        vecs = []
        for f in files:
            n = Path(f).name
            names.append(n[:-len(".vec")] if n.endswith(".vec") else n)
            with trace.span("read.vec"):
                vecs.append(textfmt.read_vector(f))
        lens = {len(v) for v in vecs}
        if len(lens) != 1:
            raise ExecutionFailed(f"feature vectors disagree on length: {lens}")
        vecs = np.stack(vecs)
        trace.h2d(self.device, vecs)
        with trace.span("matrix.bray_curtis"):
            mat = bray_curtis_matrix(torch.from_numpy(vecs).to(self.device))
        mat = host(mat)

        out = self.get("matrix-file")
        out = Path(str(out).replace("$DT", time.strftime("%Y-%m-%d_%H-%M-%S")))
        out.parent.mkdir(parents=True, exist_ok=True)
        with trace.span("write.matrix", out):
            textfmt.write_dist_matrix(
                str(out), mat,
                None if self.get("without-header") else names)
        self.info(f"Distance matrix printed to {out}")
        self.set_output("matrix-file", str(out))
        self.set_output("names", names)

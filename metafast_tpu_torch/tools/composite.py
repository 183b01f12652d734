"""heatmap-maker and the matrix-builder composite (default tool).

Counterpart of metafast_tpu/tools/composite.py (:22-176); parity:
src/tools/HeatMapMakerMain.java, DistanceMatrixBuilderMain.java.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from ..io import textfmt
from ..viz.heatmap import render_heatmap
from .framework import ExecutionFailed, Param, Tool, late_bind, register
from .pipeline1 import (ComponentCutterTool, DistMatrixCalculatorTool,
                        FeaturesCalculatorTool, KmerCounterManyTool,
                        SeqBuilderManyTool)


@register
class HeatMapMakerTool(Tool):
    NAME = "heatmap-maker"
    DESCRIPTION = "constructs heatmap with dendrogram for distance matrix"
    PARAMS = [
        Param("matrix-file", Path, "i", mandatory=True,
              description="file with distance matrix"),
        Param("colors-file", Path, "col",
              description="file with colors in #RRGGBB format, one sample "
                          "per line in matrix-file order"),
        Param("without-renumbering", bool, "wr", default=False,
              description="don't renumber samples in the heatmap"),
        Param("newMatrix-file", Path,
              description="resulting renumbered matrix file",
              default_comment="<dist-matrix-file>_renumbered.txt"),
        Param("heatmap-file", Path,
              description="resulting heatmap file",
              default_comment="<dist-matrix-file>_heatmap.png"),
        Param("invert-colors", bool, default=False,
              description="invert colors in heatmap"),
        Param("output-format", str, default="%.4f",
              description="output format for distance values"),
    ]

    def run_impl(self):
        try:
            import matplotlib  # noqa: F401  (render_heatmap draws with it)
        except ImportError as e:
            raise ExecutionFailed(
                f"heatmap-maker needs the 'matplotlib' package, which is not "
                f"installed ({e}); stop before this step with --finish "
                f"dist-matrix-calculator") from e
        mpath = self.get("matrix-file")
        mat, names = textfmt.read_dist_matrix(str(mpath))
        if names is None:
            names = [str(i + 1) for i in range(len(mat))]

        colors = None
        if self.get("colors-file"):
            colors = Path(self.get("colors-file")).read_text().split()

        ts = time.strftime("%Y-%m-%d_%H-%M-%S")
        prefix = str(mpath)
        if prefix.endswith(".txt"):
            prefix = prefix[:-4]
        renumber = not self.get("without-renumbering")

        if renumber:
            new_matrix = self.get("newMatrix-file")
            new_matrix = (str(new_matrix).replace("$DT", ts) if new_matrix
                          else prefix + "_renumbered.txt")
        else:
            new_matrix = str(mpath)

        heatmap = self.get("heatmap-file")
        if heatmap:
            heatmap = str(heatmap).replace("$DT", ts)
        else:
            hp = new_matrix
            heatmap = (hp[:-4] if hp.endswith(".txt") else hp) + "_heatmap.png"
        svg = (heatmap[:-4] if heatmap.endswith(".png") else heatmap) + ".svg"

        Path(heatmap).parent.mkdir(parents=True, exist_ok=True)
        perm = render_heatmap(mat, names, heatmap, svg, renumber=renumber,
                              invert_colors=self.get("invert-colors"),
                              colors=colors, fmt=self.get("output-format"))
        if renumber:
            Path(new_matrix).parent.mkdir(parents=True, exist_ok=True)
            textfmt.write_dist_matrix(new_matrix, mat[np.ix_(perm, perm)],
                                      [names[p] for p in perm],
                                      fmt=self.get("output-format"))
            self.info(f"Renumbered matrix saved to {new_matrix}")
        self.info(f"Heatmap for matrix saved to {heatmap}")
        self.set_output("heatmap-file", heatmap)
        self.set_output("newMatrix-file-out", new_matrix)


@register
class MatrixBuilderTool(Tool):
    NAME = "matrix-builder"
    DESCRIPTION = ("Builds the distance matrix for input sequences "
                   "(default tool)")
    PARAMS = [
        Param("k", int, "k", default=31,
              description="k-mer size (maximum 31)"),
        Param("reads", Path, "i", mandatory=True, multiple=True,
              description="list of reads files from single environment"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("min-seq-len", int, "l", default=100,
              description="minimal sequence length"),
        Param("min-component-size", int, "b1", default=1000,
              description="minimum component size (in k-mers)"),
        Param("max-component-size", int, "b2", default=10000,
              description="maximum component size (in k-mers)"),
        Param("use-reads-for-calculating-features", bool, default=False,
              description="use reads instead of k-mer files for features"),
        Param("matrix-file", Path,
              default_comment="<workDir>/matrices/dist_matrix_<date>_<time>.txt",
              description="resulting distance matrix file"),
        Param("heatmap-file", Path,
              default_comment="<workDir>/matrices/dist_matrix_<date>_<time>_heatmap.png",
              description="resulting heatmap file"),
    ]

    def run_impl(self):
        # file names carry a literal $DT placeholder; the steps substitute
        # their run timestamp at execution time (reference Tool.java:663-664)
        # so that --continue input-equality checks are timestamp-free
        mat_dir = self.workdir / "matrices"

        counter = KmerCounterManyTool()
        counter.set("k", self.get("k"))
        counter.set("reads", self.get("reads"))
        counter.set("maximal-bad-frequency", self.get("maximal-bad-frequency"))
        self.add_step(counter)

        builder = SeqBuilderManyTool()
        builder.set("k", self.get("k"))
        builder.set("maximal-bad-frequency", self.get("maximal-bad-frequency"))
        builder.set("sequence-len", self.get("min-seq-len"))
        late_bind(builder, "k-mers",
                  lambda: counter.outputs["resulting-kmers-files"])
        self.add_step(builder)

        cutter = ComponentCutterTool()
        cutter.set("k", self.get("k"))
        cutter.set("min-seq-len", self.get("min-seq-len"))
        cutter.set("min-component-size", self.get("min-component-size"))
        cutter.set("max-component-size", self.get("max-component-size"))
        late_bind(cutter, "sequences",
                  lambda: builder.outputs["output-files"])
        self.add_step(cutter)

        features = FeaturesCalculatorTool()
        features.set("k", self.get("k"))
        late_bind(features, "components",
                  lambda: cutter.outputs["components-file"])
        if self.get("use-reads-for-calculating-features"):
            features.set("reads", self.get("reads"))
        else:
            late_bind(features, "k-mers",
                      lambda: counter.outputs["resulting-kmers-files"])
        self.add_step(features)

        dist = DistMatrixCalculatorTool()
        late_bind(dist, "features",
                  lambda: features.outputs["features-files"])
        dist.set("matrix-file",
                 mat_dir / "dist_matrix_$DT_original_order.txt")
        self.add_step(dist)

        heat = HeatMapMakerTool()
        late_bind(heat, "matrix-file",
                  lambda: dist.outputs["matrix-file"])
        mf = self.get("matrix-file")
        heat.set("newMatrix-file",
                 str(mf) if mf else str(mat_dir / "dist_matrix_$DT.txt"))
        hf = self.get("heatmap-file")
        heat.set("heatmap-file",
                 str(hf) if hf else str(mat_dir / "dist_matrix_$DT_heatmap.png"))
        self.add_step(heat)

"""component-extractor: pivot-anchored component extraction.

Counterpart of metafast_tpu/tools/extract_tools.py (:18-63); parity:
src/tools/ComponentExtractorMain.java.  The tables are loaded on
``ctx.device`` and come to the host once for the traversal; both the
native (depth 1) and the Python traversal have their neighbor-index
tables built on ``ctx.device``.
"""

from __future__ import annotations

from pathlib import Path

from .. import api
from ..graph.pivot import split_around_pivot
from ..io import binfmt
from ..utils import trace
from .framework import Param, Tool, host, register


@register
class ComponentExtractorTool(Tool):
    NAME = "component-extractor"
    DESCRIPTION = ("Extract graph components from tangled graph based on "
                   "pivot k-mers")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="input files with graph k-mers in binary format"),
        Param("pivot", Path, mandatory=True, multiple=True,
              description="input files with pivot k-mers in binary format"),
        Param("components-file", Path,
              default=lambda t: (t.workdir or Path(".")) / "components.bin",
              description="file to write found components to"),
        Param("depth", int, default=1,
              description="depth of traversal from pivot k-mers"),
    ]

    def run_impl(self):
        k = self.get("k")
        dev = self.device
        with trace.span("extract.load"):
            keys, counts = map(host, api.load_kmers_bin(
                [str(f) for f in self.get("k-mers")], 0, dev))
            pivot_keys = host(api.load_kmers_bin(
                [str(f) for f in self.get("pivot")], 0, dev)[0])
        self.info(f"{len(keys)} graph k-mers, {len(pivot_keys)} pivot k-mers")

        comps = split_around_pivot(keys, counts, k, pivot_keys,
                                   self.get("depth"), device=dev)
        self.info(f"Total {len(comps)} components were found")
        trace.count("pivot_kmers", sum(c.size for c in comps))
        if not comps:
            self.warn("No components were extracted!")

        out = self.get("components-file")
        out.parent.mkdir(parents=True, exist_ok=True)
        with trace.span("write.components", out):
            binfmt.write_components_bin(str(out),
                                        [(c.kmers, c.weight) for c in comps])
        stat_fp = self.workdir / "components-stat.txt"
        with trace.span("write.components_stat", stat_fp), \
                open(stat_fp, "w") as fh:
            fh.write("# component.no\tcomponent.size\tcomponent.weight"
                     "\tcomponent.nPivotKmers\tusedFreqThreshold\n")
            for i, c in enumerate(comps):
                fh.write(f"{i + 1}\t{c.size}\t{c.weight}\t{c.n_pivot}"
                         f"\t{c.used_freq_threshold}\n")
        self.info(f"Components saved to {out}")
        self.set_output("components-file", str(out))
        self.set_output("components-stat", str(stat_fp))

"""Pipeline 2/5 composites: unique-features, stats-features.

Counterpart of metafast_tpu/tools/composite2.py (:20-167); parity:
src/tools/UniqueFeaturesBuilderMain.java, StatsFeaturesBuilderMain.java.
Chains of the port's tools: the counting and feature steps run on
``ctx.device``, the statistics and the traversal on the host.
"""

from __future__ import annotations

from pathlib import Path

from .convert import ComponentsToSequencesTool
from .extract_tools import ComponentExtractorTool
from .filter_tools import (KmerCounterPosNegTool, KmersFilterTool,
                           UniqueKmersMultiTool)
from .framework import ExecutionFailed, Param, Tool, late_bind, register
from .pipeline1 import FeaturesCalculatorTool
from .stats_tools import StatsKmersTool


@register
class UniqueFeaturesTool(Tool):
    NAME = "unique-features"
    DESCRIPTION = ("Build features based on k-mers unique to the positive "
                   "group (pipeline 2)")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("positiveReads", Path, "pos", mandatory=True, multiple=True,
              description="reads files from positive group"),
        Param("negativeReads", Path, "neg", mandatory=True, multiple=True,
              description="reads files from negative group"),
        Param("min-samples", int, default=1,
              description="minimal number of samples k-mer to be present in"),
        Param("max-samples", int, default=1,
              description="maximal number of samples k-mer to be present in"),
        Param("split", bool, default=False,
              description="save each component in separate file"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
    ]

    def run_impl(self):
        if not self.get("positiveReads") or not self.get("negativeReads"):
            raise ExecutionFailed("No libraries to process!")
        k = self.get("k")
        b = self.get("maximal-bad-frequency")

        posneg = KmerCounterPosNegTool()
        posneg.set("k", k)
        posneg.set("positiveReads", self.get("positiveReads"))
        posneg.set("negativeReads", self.get("negativeReads"))
        posneg.set("maximal-bad-frequency", b)
        self.add_step(posneg)

        unique = UniqueKmersMultiTool()
        unique.set("k", k)
        unique.set("min-samples", self.get("min-samples"))
        unique.set("max-samples", self.get("max-samples"))
        unique.set("maximal-bad-frequency", b)
        late_bind(unique, "k-mers",
                  lambda: posneg.outputs["resulting-pos-kmers-files"])
        late_bind(unique, "filter-kmers",
                  lambda: posneg.outputs["resulting-neg-kmers-files"])
        self.add_step(unique)

        kfilter = KmersFilterTool()
        kfilter.set("k", k)
        kfilter.set("maximal-bad-frequency", b)
        late_bind(kfilter, "k-mers",
                  lambda: posneg.outputs["resulting-pos-kmers-files"])
        late_bind(kfilter, "filter-kmers",
                  lambda: [unique.outputs["resulting-kmers-file"]])
        self.add_step(kfilter)

        extractor = ComponentExtractorTool()
        extractor.set("k", k)
        late_bind(extractor, "k-mers",
                  lambda: posneg.outputs["resulting-pos-kmers-files"])
        late_bind(extractor, "pivot",
                  lambda: [unique.outputs["resulting-kmers-file"]])
        self.add_step(extractor)

        features = FeaturesCalculatorTool()
        features.set("k", k)
        late_bind(features, "components",
                  lambda: extractor.outputs["components-file"])
        late_bind(features, "k-mers",
                  lambda: posneg.outputs["resulting-pos-kmers-files"])
        late_bind(features, "selected-kmers",
                  lambda: [unique.outputs["resulting-kmers-file"]])
        self.add_step(features)

        c2s = ComponentsToSequencesTool()
        c2s.set("k", k)
        c2s.set("split", self.get("split"))
        late_bind(c2s, "components-file",
                  lambda: extractor.outputs["components-file"])
        self.add_step(c2s)


@register
class StatsFeaturesTool(Tool):
    NAME = "stats-features"
    DESCRIPTION = ("Build features based on statistically significant "
                   "k-mers (pipeline 5)")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("positiveReads", Path, "pos", mandatory=True, multiple=True,
              description="reads files from positive group"),
        Param("negativeReads", Path, "neg", mandatory=True, multiple=True,
              description="reads files from negative group"),
        Param("p-value-chi2", float, "pchi2", default=0.05,
              description="p-value for chi-squared test"),
        Param("p-value-mw", float, "pmw", default=0.05,
              description="p-value for Mann-Whitney test"),
        Param("split", bool, default=False,
              description="save each component in separate file"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
    ]

    def run_impl(self):
        if not self.get("positiveReads") or not self.get("negativeReads"):
            raise ExecutionFailed("No libraries to process!")
        k = self.get("k")
        b = self.get("maximal-bad-frequency")

        posneg = KmerCounterPosNegTool()
        posneg.set("k", k)
        posneg.set("positiveReads", self.get("positiveReads"))
        posneg.set("negativeReads", self.get("negativeReads"))
        posneg.set("maximal-bad-frequency", b)
        self.add_step(posneg)

        stats = StatsKmersTool()
        stats.set("p-value-chi2", self.get("p-value-chi2"))
        stats.set("p-value-mw", self.get("p-value-mw"))
        stats.set("maximal-bad-frequency", b)
        late_bind(stats, "a-kmers",
                  lambda: posneg.outputs["resulting-pos-kmers-files"])
        late_bind(stats, "b-kmers",
                  lambda: posneg.outputs["resulting-neg-kmers-files"])
        self.add_step(stats)

        extractor = ComponentExtractorTool()
        extractor.set("k", k)
        late_bind(extractor, "k-mers",
                  lambda: posneg.outputs["resulting-pos-kmers-files"])
        late_bind(extractor, "pivot",
                  lambda: stats.outputs["resulting-kmers-file"])
        self.add_step(extractor)

        features = FeaturesCalculatorTool()
        features.set("k", k)
        late_bind(features, "components",
                  lambda: extractor.outputs["components-file"])
        late_bind(features, "k-mers",
                  lambda: posneg.outputs["resulting-pos-kmers-files"])
        late_bind(features, "selected-kmers",
                  lambda: stats.outputs["resulting-kmers-file"])
        self.add_step(features)

        c2s = ComponentsToSequencesTool()
        c2s.set("k", k)
        c2s.set("split", self.get("split"))
        late_bind(c2s, "components-file",
                  lambda: extractor.outputs["components-file"])
        self.add_step(c2s)

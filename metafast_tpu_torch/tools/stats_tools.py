"""Statistical k-mer selection tools.

Parity: src/tools/StatsKmersFinder.java (stats-kmers),
StatsKmers3GroupsFinder.java (stats-kmers-3),
BitSetStatsKmers3GroupsFinder.java (bitset-stats-kmers-3 — same semantics,
different map backend in the reference), specific-kmers(-3),
top-stats-kmers, subset-specific.

Counterpart of metafast_tpu/tools/stats_tools.py (:1-469).  Every tool's
passes over the samples run on the run's device (``stats.presence``),
and so does every Mann-Whitney (``stats.tests.mannwhitney_p``).  The
float32 chi-squared statistic stays host NumPy, computed once a possible
input and looked up on the device; the group means of the kept rows stay
host NumPy too.  The stats and specific tools share one flow
(``_GroupTestTool``) and differ only where the reference does.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..io import binfmt, textfmt
from ..stats import presence as pres
from ..stats.tests import (chi2_invcdf_df1, chi2_invcdf_df2, chisq3_reference,
                           chisq_reference, chisq_statistic2,
                           chisq_statistic3, mannwhitney_p)
from ..utils import trace
from .framework import (ExecutionFailed, Param, Tool, host, register,
                        workdir_sub)


def _write_group_file(path, keys, means):
    """{key, (short) mean} records (StatsKmersFinder.java:259-268)."""
    vals = np.asarray(means, dtype=np.int64).astype(np.int16)
    binfmt.write_kmers_bin(str(path), keys, vals)


def _group_keys(groups, b: int, device):
    """Over the files of every group, in order, on ``device``: the sorted
    union of their keys of count > b and each group's presence count of
    every key (the ``stats.presence.*`` spans)."""
    tabs = pres.LazyTables([f for g in groups for f in g], b, device)
    with trace.span("stats.presence.union"):
        keys = pres.union_keys(tabs)
    with trace.span("stats.presence.groups"):
        n1 = pres.group_presence_counts(tabs, keys, [len(g) for g in groups])
    return keys, n1


def _per_presence(fn, sizes, n1, *args) -> torch.Tensor:
    """Per key, ``fn(n0A, n1A, n0B, n1B[, n0C, n1C], *args)`` of its
    presence counts ``n1`` in groups of ``sizes``, on their device.  A
    chi-squared function of the counts alone, it is computed on the host
    once for each possible tuple, as the reference computes it (float32),
    and looked up."""
    grid = np.meshgrid(*(np.arange(s + 1) for s in sizes), indexing="ij")
    counts = [x for s, g in zip(sizes, grid) for x in (s - g, g)]
    idx = n1[0]
    for s, n in zip(sizes[1:], n1[1:]):
        idx = idx * (s + 1) + n
    return torch.from_numpy(fn(*counts, *args).ravel()).to(idx.device)[idx]


def _split_by_means(means):
    """Per group, the kept rows whose mean there is above every other
    group's; the last group takes the rest (as StatsKmersFinder.java and
    StatsKmers3GroupsFinder.java split them)."""
    masks, taken = [], np.zeros(len(means[0]), dtype=bool)
    for g, m in enumerate(means[:-1]):
        top = ~taken
        for h, other in enumerate(means):
            if h != g:
                top &= m > other
        masks.append(top)
        taken |= top
    return masks + [~taken]


class _GroupTestTool(Tool):
    """Chi-squared over presence, then Mann-Whitney over the survivors'
    counts, then each kept k-mer to the group of highest mean.

    The stats tools (StatsKmersFinder.java, StatsKmers3GroupsFinder.java)
    and the specific tools (SpecificKmersFinder.java,
    SpecificKmers3GroupsFinder.java) differ only in what ``SPECIFIC``
    switches: the specific tools read raw (not depth-normalized)
    frequencies; their scarce test compares the k-mer's count in the
    *first* sample containing it, not its number of samples, with
    ceil(0.05 * n_samples) (SpecificKmersFinder.java:155-158); k-mers
    present in all samples force-pass chi² instead of failing it; with 2
    groups MW keeps p <= threshold, not p < threshold; and they write no
    chi-squared file.  The degrees of freedom follow the group count.
    """

    GROUPS = ("a-kmers", "b-kmers")
    SPECIFIC = False
    TOTAL_MESSAGE = "Total group {} k-mers = {}"

    def run_impl(self):
        groups = [self.get(p) for p in self.GROUPS]
        sizes = [len(g) for g in groups]
        total = sum(sizes)
        dev = self.device
        b = 0 if self.SPECIFIC else self.get("maximal-bad-frequency")
        freq_tabs = pres.LazyTables([f for g in groups for f in g], 0, dev)
        tots = None if self.SPECIFIC else pres.sample_totals(freq_tabs)
        keys, n1 = _group_keys(groups, b, dev)
        n = len(keys)

        with trace.span("stats.chi2"):
            present = sum(n1)
            in_all = present == total
            level = 1.0 - self.get("p-value-chi2")
            passed = (_per_presence(chisq_reference, sizes, n1,
                                    chi2_invcdf_df1(level))
                      if len(sizes) == 2 else
                      _per_presence(chisq3_reference, sizes, n1,
                                    chi2_invcdf_df2(level)))
            if self.SPECIFIC:
                scarce = (pres.first_present_value(freq_tabs, keys)
                          <= math.ceil(total * 0.05))
                chi_keys = keys[~scarce & (passed | in_all)]
            else:
                scarce = present <= math.ceil(total * 0.05)
                chi_keys = keys[~scarce & ~in_all & passed]
                chi_host = host(chi_keys)
        trace.count("stats_keys", n)
        trace.count("stats_survivors", len(chi_keys))

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        f_chi = None
        if not self.SPECIFIC:
            f_chi = out_dir / "filtered_chisquared.kmers.bin"
            f_chi_stat = out_dir / "filtered_chisquared.stat.txt"
            with trace.span("write.kmers_bin", f_chi):
                binfmt.write_kmers_bin(
                    str(f_chi), chi_host,
                    np.ones(len(chi_host), dtype=np.int16))
            with trace.span("write.stat", f_chi_stat):
                textfmt.write_stat_txt(
                    str(f_chi_stat), np.ones(len(chi_host), dtype=np.int32))
            self.info(f"{len(chi_host)} k-mers survived the chi-squared "
                      f"test (of {n}; {int(scarce.sum())} scarce, "
                      f"{int(in_all.sum())} in all samples)")

        # frequencies over the surviving keys only (StatsKmersFinder.java:
        # 222-247) — count matrices are densified for the chi-squared
        # SURVIVORS, never the full union
        with trace.span("stats.mw"):
            mats = pres.count_matrix(freq_tabs, chi_keys).double()
            if tots is not None:                 # depth-normalized
                mean_sum = float(tots.sum()) / total
                mats = mats * mean_sum / torch.from_numpy(tots).to(dev)
            mats = mats.split(sizes, dim=1)

            pmw = self.get("p-value-mw")
            if pmw > 0 and len(chi_keys):
                at_most = self.SPECIFIC and len(sizes) == 2
                pairs = ([(0, 1)] if len(sizes) == 2
                         else [(0, 1), (1, 2), (0, 2)])
                keep = torch.zeros(len(chi_keys), dtype=torch.bool,
                                   device=dev)
                for i, j in pairs:
                    p = mannwhitney_p(mats[i], mats[j])
                    keep |= (p <= pmw) if at_most else (p < pmw)
            else:
                keep = torch.ones(len(chi_keys), dtype=torch.bool,
                                  device=dev)

            # the group means of the kept rows, on the host
            kept = host(chi_keys[keep])
            means = [host(m[keep]).mean(axis=1) for m in mats]

        outs = []
        for label, mask, mean in zip("ABC", _split_by_means(means), means):
            fp = out_dir / f"filtered_group{label}.kmers.bin"
            with trace.span("write.kmers_bin", fp):
                _write_group_file(fp, kept[mask], mean[mask])
            self.info(self.TOTAL_MESSAGE.format(label, int(mask.sum())))
            outs.append(str(fp))
        self.set_outputs(outs, f_chi)

    def set_outputs(self, outs, f_chi):
        self.set_output("resulting-kmers-files", outs)
        if f_chi:
            self.set_output("filtered-chisquared", str(f_chi))


_STATS_PARAMS = [
    Param("a-kmers", Path, "A", mandatory=True, multiple=True,
          description="list of input k-mer files for group A"),
    Param("b-kmers", Path, "B", mandatory=True, multiple=True,
          description="list of input k-mer files for group B"),
    Param("c-kmers", Path, "C", mandatory=True, multiple=True,
          description="list of input k-mer files for group C"),
    Param("p-value-chi2", float, "pchi2", default=0.05,
          description="p-value for chi-squared test"),
    Param("p-value-mw", float, "pmw", default=0.05,
          description="p-value for Mann-Whitney test"),
    Param("maximal-bad-frequency", int, "b", default=0,
          description="maximal frequency for an erroneous k-mer"),
    Param("output-dir", Path, default=workdir_sub("kmers"),
          description="Output directory"),
]


@register
class StatsKmersTool(_GroupTestTool):
    NAME = "stats-kmers"
    DESCRIPTION = ("Output k-mers statistically significant to each of two "
                   "groups of samples based on chi-squared & Mann-Whitney test")
    PARAMS = _STATS_PARAMS[:2] + _STATS_PARAMS[3:]

    def set_outputs(self, outs, f_chi):
        fA, fB = outs
        self.set_output("resulting-kmers-file", [fA])
        self.set_output("filtered-chisquared", str(f_chi))
        self.set_output("group-a-file", fA)
        self.set_output("group-b-file", fB)


class _StatsKmers3Base(_GroupTestTool):
    GROUPS = ("a-kmers", "b-kmers", "c-kmers")
    PARAMS = _STATS_PARAMS


@register
class StatsKmers3Tool(_StatsKmers3Base):
    NAME = "stats-kmers-3"
    DESCRIPTION = ("Output k-mers statistically significant to each of three "
                   "groups of samples based on chi-squared & Mann-Whitney test")


@register
class BitSetStatsKmers3Tool(_StatsKmers3Base):
    NAME = "bitset-stats-kmers-3"
    DESCRIPTION = ("3-group stats k-mers (BitSet-backed variant in the "
                   "reference; identical semantics here)")


class _SpecificKmersBase(_GroupTestTool):
    """Frequency-table chi² + MW specific k-mer extraction
    (src/tools/SpecificKmersFinder.java, SpecificKmers3GroupsFinder.java)."""

    SPECIFIC = True
    TOTAL_MESSAGE = "Total specific k-mers in Group {} = {}"


_SPECIFIC_PARAMS = [
    Param("a-kmers", Path, "A", mandatory=True, multiple=True,
          description="k-mer files for group A"),
    Param("b-kmers", Path, "B", mandatory=True, multiple=True,
          description="k-mer files for group B"),
    Param("c-kmers", Path, "C", mandatory=True, multiple=True,
          description="k-mer files for group C"),
    Param("p-value-chi2", float, "pchi2", default=0.05,
          description="p-value for chi-squared test"),
    Param("p-value-mw", float, "pmw", default=0.05,
          description="p-value for Mann-Whitney test"),
    Param("output-dir", Path, default=workdir_sub("kmers")),
]


@register
class SpecificKmersTool(_SpecificKmersBase):
    NAME = "specific-kmers"
    DESCRIPTION = ("Output k-mers specific to each of two groups of samples "
                   "based on frequency chi-squared & Mann-Whitney tests")
    PARAMS = _SPECIFIC_PARAMS[:2] + _SPECIFIC_PARAMS[3:]


@register
class SpecificKmers3Tool(_SpecificKmersBase):
    NAME = "specific-kmers-3"
    DESCRIPTION = ("Output k-mers specific to each of three groups of "
                   "samples based on frequency chi-squared & Mann-Whitney")
    GROUPS = ("a-kmers", "b-kmers", "c-kmers")
    PARAMS = _SPECIFIC_PARAMS


@register
class TopStatsKmersTool(Tool):
    NAME = "top-stats-kmers"
    DESCRIPTION = ("Output top N k-mers ranked by the chi-squared statistic "
                   "(2 or 3 groups)")
    PARAMS = [
        Param("a-kmers", Path, "A", mandatory=True, multiple=True,
              description="k-mer files for group A"),
        Param("b-kmers", Path, "B", mandatory=True, multiple=True,
              description="k-mer files for group B"),
        Param("c-kmers", Path, "C", multiple=True,
              description="k-mer files for group C (optional)"),
        Param("num-kmers", int, "n", mandatory=True,
              description="number of most specific k-mers to extract"),
        Param("maximal-bad-frequency", int, "b", default=0,
              description="maximal frequency for an erroneous k-mer"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
    ]

    def run_impl(self):
        b = self.get("maximal-bad-frequency")
        groups = [self.get("a-kmers"), self.get("b-kmers")]
        if self.get("c-kmers"):
            groups.append(self.get("c-kmers"))
        sizes = [len(g) for g in groups]
        total = sum(sizes)
        keys, n1 = _group_keys(groups, b, self.device)
        present = sum(n1)
        eligible = (present > math.ceil(total * 0.05)) & (present != total)
        keys = host(keys[eligible])
        stat = _per_presence(chisq_statistic2 if len(sizes) == 2
                             else chisq_statistic3, sizes, n1)
        stats_sel = host(stat[eligible])
        # rank 0 = largest statistic (TopStatsKmersFinder.java:166-173)
        order = np.argsort(-stats_sel, kind="stable")
        ranks = np.empty(len(keys), dtype=np.int32)
        ranks[order] = np.arange(len(keys), dtype=np.int32)

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        n_best = self.get("num-kmers")
        all_file = out_dir / "all.kmers.bin"
        ranks_file = out_dir / "all_chi_squared_ranks.bin"
        top_file = out_dir / f"top_{n_best}_chi_squared_specific.kmers.bin"

        binfmt.write_kmers_bin(str(all_file), keys,
                               np.ones(len(keys), dtype=np.int16))
        ranks_file.write_bytes(ranks.astype(">i4").tobytes())
        top = ranks < n_best
        binfmt.write_kmers_bin(str(top_file), keys[top],
                               np.ones(int(top.sum()), dtype=np.int16))
        self.info(f"Filtered k-mers printed to {top_file}")
        self.set_output("resulting-kmers-file", str(top_file))
        self.set_output("all-kmers-file", str(all_file))
        self.set_output("ranks-file", str(ranks_file))


@register
class SubsetSpecificTool(Tool):
    NAME = "subset-specific"
    DESCRIPTION = ("Output subset of top most specific k-mers based on "
                   "given statistical ranking")
    PARAMS = [
        Param("input-kmers", Path, "i", mandatory=True,
              description="file with filtered k-mers in binary format"),
        Param("ranks-kmers", Path, "rk", mandatory=True,
              description="file with k-mer ranks in binary format"),
        Param("num-kmers", int, "n", mandatory=True,
              description="number of most specific k-mers to extract"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
    ]

    def run_impl(self):
        keys, counts = binfmt.read_kmers_bin(str(self.get("input-kmers")))
        ranks = np.frombuffer(
            Path(self.get("ranks-kmers")).read_bytes(), dtype=">i4"
        ).astype(np.int32)
        n_best = self.get("num-kmers")
        if len(keys) < n_best:
            raise ExecutionFailed(
                "Trying to extract more k-mers then present in input file!")
        if len(ranks) < len(keys):
            raise ExecutionFailed("ranks file shorter than k-mers file")
        keep = ranks[: len(keys)] < n_best
        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        stem = Path(self.get("ranks-kmers")).name.split(".")[0].split("_ranks")[0]
        out_file = out_dir / f"{stem}_top_{n_best}.kmers.bin"
        binfmt.write_kmers_bin(str(out_file), keys[keep], counts[keep])
        self.info(f"Top k-mers printed to {out_file}")
        self.set_output("resulting-kmers-file", str(out_file))

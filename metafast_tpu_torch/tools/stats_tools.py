"""Statistical k-mer selection tools.

Parity: src/tools/StatsKmersFinder.java (stats-kmers),
StatsKmers3GroupsFinder.java (stats-kmers-3),
BitSetStatsKmers3GroupsFinder.java (bitset-stats-kmers-3 — same semantics,
different map backend in the reference), specific-kmers(-3),
top-stats-kmers, subset-specific.

Counterpart of metafast_tpu/tools/stats_tools.py (:1-469): host NumPy
over ``stats.presence``, as there, but for ``stats-kmers``, whose passes
over the samples run on the run's device (the ``*_device`` builders);
the float32 chi-squared statistic and the p-values stay host NumPy, each
computed once a distinct input.
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
                           chisq_statistic3, mannwhitney_p_rows,
                           mannwhitney_p_umin, mannwhitney_umin2_rows_device)
from ..utils import trace
from .framework import (ExecutionFailed, Param, Tool, host, register,
                        workdir_sub)


def _load_group_tables(files, b, device=None):
    """Presence tables (count > b) and frequency tables (all records).

    Lazy: each returned table set streams one sample file at a time, so
    peak memory stays O(union keys) + one sample even at CAMI scale.
    With a ``device``, the tables are tensors there."""
    pres_tabs = pres.LazyTables(files, b, device)
    freq_tabs = pres.LazyTables(files, 0, device)
    totals = pres.sample_totals(freq_tabs)
    return pres_tabs, freq_tabs, totals


def _write_group_file(path, keys, means):
    """{key, (short) mean} records (StatsKmersFinder.java:259-268)."""
    vals = np.asarray(means, dtype=np.int64).astype(np.int16)
    binfmt.write_kmers_bin(str(path), keys, vals)


@register
class StatsKmersTool(Tool):
    NAME = "stats-kmers"
    DESCRIPTION = ("Output k-mers statistically significant to each of two "
                   "groups of samples based on chi-squared & Mann-Whitney test")
    PARAMS = [
        Param("a-kmers", Path, "A", mandatory=True, multiple=True,
              description="list of input k-mer files for group A"),
        Param("b-kmers", Path, "B", mandatory=True, multiple=True,
              description="list of input k-mer files for group B"),
        Param("p-value-chi2", float, "pchi2", default=0.05,
              description="p-value for chi-squared test"),
        Param("p-value-mw", float, "pmw", default=0.05,
              description="p-value for Mann-Whitney test"),
        Param("maximal-bad-frequency", int, "b", default=0,
              description="maximal frequency for an erroneous k-mer"),
        Param("output-dir", Path, default=workdir_sub("kmers"),
              description="Output directory"),
    ]

    def run_impl(self):
        a_files = self.get("a-kmers")
        b_files = self.get("b-kmers")
        SA, SB = len(a_files), len(b_files)
        total = SA + SB
        b = self.get("maximal-bad-frequency")

        dev = self.device
        a_pres, a_freq, a_tot = _load_group_tables(a_files, b, dev)
        b_pres, b_freq, b_tot = _load_group_tables(b_files, b, dev)
        with trace.span("stats.presence.union"):
            keys = pres.union_keys_device(a_pres + b_pres)
        # chunked per-group presence counts: no [N, S] matrix is ever
        # densified (CAMI-scale N x 9 bytes/cell would be 100s of GB; the
        # reference spends ~1 bit, Long2BitShortaHashMap.java:13-120)
        with trace.span("stats.presence.groups"):
            n1A, n1B = pres.group_presence_counts_device(
                a_pres + b_pres, keys, [SA, SB])
        n = len(keys)

        with trace.span("stats.chi2"):
            present = n1A + n1B
            scarce = present <= math.ceil(total * 0.05)
            in_all = present == total
            eligible = ~scarce & ~in_all

            # the statistic is a function of (n1A, n1B) alone: computed
            # once a pair, as chisq_reference computes it, and looked up
            crit = chi2_invcdf_df1(1.0 - self.get("p-value-chi2"))
            ga, gb = np.meshgrid(np.arange(SA + 1), np.arange(SB + 1),
                                 indexing="ij")
            passed = torch.from_numpy(chisq_reference(
                SA - ga, ga, SB - gb, gb, crit).ravel()).to(dev)
            chi_keys = keys[eligible & passed[n1A * (SB + 1) + n1B]]
            chi_host = host(chi_keys)
        trace.count("stats_keys", n)
        trace.count("stats_survivors", len(chi_keys))

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        f_chi = out_dir / "filtered_chisquared.kmers.bin"
        f_chi_stat = out_dir / "filtered_chisquared.stat.txt"
        with trace.span("write.kmers_bin", f_chi):
            binfmt.write_kmers_bin(str(f_chi), chi_host,
                                   np.ones(len(chi_host), dtype=np.int16))
        with trace.span("write.stat", f_chi_stat):
            textfmt.write_stat_txt(str(f_chi_stat),
                                   np.ones(len(chi_host), dtype=np.int32))
        self.info(f"{len(chi_host)} k-mers survived the chi-squared test "
                  f"(of {n}; {int(scarce.sum())} scarce, "
                  f"{int(in_all.sum())} in all samples)")

        # depth-normalized frequencies over the surviving keys only
        # (StatsKmersFinder.java:222-247) — count matrices are densified
        # for the chi-squared SURVIVORS, never the full union
        with trace.span("stats.mw"):
            mean_sum = float(np.concatenate([a_tot, b_tot]).sum()) / total
            A = pres.count_matrix_device(a_freq, chi_keys).double()
            B = pres.count_matrix_device(b_freq, chi_keys).double()
            A = A * mean_sum / torch.from_numpy(a_tot).to(dev)[None, :]
            B = B * mean_sum / torch.from_numpy(b_tot).to(dev)[None, :]

            pmw = self.get("p-value-mw")
            if pmw > 0 and len(chi_keys):
                # U_min takes few values: one p-value each
                u2, inv = torch.unique(mannwhitney_umin2_rows_device(A, B),
                                       return_inverse=True)
                p = mannwhitney_p_umin(host(u2) / 2.0, SA, SB)
                keep = torch.from_numpy(p < pmw).to(dev)[inv]
            else:
                keep = torch.ones(len(chi_keys), dtype=torch.bool,
                                  device=dev)

            # the group means of the kept rows, on the host as before
            kept = host(chi_keys[keep])
            meanA = host(A[keep]).mean(axis=1)
            meanB = host(B[keep]).mean(axis=1)
            to_a = meanA > meanB

        fA = out_dir / "filtered_groupA.kmers.bin"
        fB = out_dir / "filtered_groupB.kmers.bin"
        with trace.span("write.kmers_bin", fA, fB):
            _write_group_file(fA, kept[to_a], meanA[to_a])
            _write_group_file(fB, kept[~to_a], meanB[~to_a])
        self.info(f"Total group A k-mers = {int(to_a.sum())}")
        self.info(f"Total group B k-mers = {int((~to_a).sum())}")
        self.set_output("resulting-kmers-file", [str(fA)])
        self.set_output("filtered-chisquared", str(f_chi))
        self.set_output("group-a-file", str(fA))
        self.set_output("group-b-file", str(fB))


class _StatsKmers3Base(Tool):
    PARAMS = [
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

    def run_impl(self):
        groups = [self.get("a-kmers"), self.get("b-kmers"),
                  self.get("c-kmers")]
        sizes = [len(g) for g in groups]
        total = sum(sizes)
        b = self.get("maximal-bad-frequency")

        pres_tabs, freq_tabs, tots = [], [], []
        for g in groups:
            p_, f_, t_ = _load_group_tables(g, b)
            pres_tabs.append(p_)
            freq_tabs.append(f_)
            tots.append(t_)

        all_pres = pres_tabs[0] + pres_tabs[1] + pres_tabs[2]
        keys = pres.union_keys(all_pres)
        # streaming per-group presence counts (no dense [N, S] matrix)
        n1 = pres.group_presence_counts(all_pres, keys, sizes)

        present_total = n1[0] + n1[1] + n1[2]
        scarce = present_total <= math.ceil(total * 0.05)
        in_all = present_total == total
        eligible = ~scarce & ~in_all

        crit = chi2_invcdf_df2(1.0 - self.get("p-value-chi2"))
        passed = chisq3_reference(
            sizes[0] - n1[0], n1[0], sizes[1] - n1[1], n1[1],
            sizes[2] - n1[2], n1[2], crit)
        sel = eligible & passed
        chi_keys = keys[sel]

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        f_chi = out_dir / "filtered_chisquared.kmers.bin"
        binfmt.write_kmers_bin(str(f_chi), chi_keys,
                               np.ones(len(chi_keys), dtype=np.int16))
        textfmt.write_stat_txt(str(out_dir / "filtered_chisquared.stat.txt"),
                               np.ones(len(chi_keys), dtype=np.int32))
        self.info(f"{len(chi_keys)} k-mers survived the chi-squared test")

        mean_sum = float(np.concatenate(tots).sum()) / total
        mats = []
        for gi in range(3):
            # densify only the chi-squared survivors
            M = pres.count_matrix(freq_tabs[gi], chi_keys).astype(np.float64)
            mats.append(M * mean_sum / tots[gi][None, :])
        A, B, C = mats

        pmw = self.get("p-value-mw")
        if pmw > 0 and len(chi_keys):
            keep = ((mannwhitney_p_rows(A, B) < pmw)
                    | (mannwhitney_p_rows(B, C) < pmw)
                    | (mannwhitney_p_rows(A, C) < pmw))
        else:
            keep = np.ones(len(chi_keys), dtype=bool)

        mA, mB, mC = A.mean(axis=1), B.mean(axis=1), C.mean(axis=1)
        to_a = keep & (mA > mB) & (mA > mC)
        to_b = keep & ~to_a & (mB > mA) & (mB > mC)
        to_c = keep & ~to_a & ~to_b

        names = ["filtered_groupA.kmers.bin", "filtered_groupB.kmers.bin",
                 "filtered_groupC.kmers.bin"]
        outs = []
        for mask, mean, fname, label in ((to_a, mA, names[0], "A"),
                                         (to_b, mB, names[1], "B"),
                                         (to_c, mC, names[2], "C")):
            fp = out_dir / fname
            _write_group_file(fp, chi_keys[mask], mean[mask])
            self.info(f"Total group {label} k-mers = {int(mask.sum())}")
            outs.append(str(fp))
        self.set_output("resulting-kmers-files", outs)
        self.set_output("filtered-chisquared", str(f_chi))


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


class _SpecificKmersBase(Tool):
    """Frequency-table chi² + MW specific k-mer extraction.

    Parity: src/tools/SpecificKmersFinder.java (2 groups) and
    SpecificKmers3GroupsFinder.java (3 groups).  Differences from
    stats-kmers: raw (not depth-normalized) frequencies; the scarce test
    compares the k-mer's count in the *first* sample containing it with
    ceil(0.05 * n_samples) (SpecificKmersFinder.java:155-158); k-mers
    present in all samples force-pass chi²; MW keeps p <= threshold.
    """

    N_GROUPS = 2

    def _group_params(self):
        return ["a-kmers", "b-kmers", "c-kmers"][: self.N_GROUPS]

    def run_impl(self):
        groups = [self.get(p) for p in self._group_params()]
        sizes = [len(g) for g in groups]
        total = sum(sizes)
        files = [f for g in groups for f in g]

        tabs = pres.LazyTables(files, 0)
        keys = pres.union_keys(tabs)
        o = np.cumsum([0] + sizes)
        # chunked presence counts + first-present value: the full union
        # is never densified into an [N, S] matrix
        n1 = pres.group_presence_counts(tabs, keys, sizes)

        # scarce test value: count in the first sample containing the key
        first_val = pres.first_present_value(tabs, keys)
        scarce = first_val <= math.ceil(total * 0.05)

        if self.N_GROUPS == 2:
            crit = chi2_invcdf_df1(1.0 - self.get("p-value-chi2"))
            passed = chisq_reference(sizes[0] - n1[0], n1[0],
                                     sizes[1] - n1[1], n1[1], crit)
        else:
            crit = chi2_invcdf_df2(1.0 - self.get("p-value-chi2"))
            passed = chisq3_reference(sizes[0] - n1[0], n1[0],
                                      sizes[1] - n1[1], n1[1],
                                      sizes[2] - n1[2], n1[2], crit)
        in_all = sum(n1) == total
        passed = passed | in_all
        keep = ~scarce & passed

        # densify frequency rows for the SURVIVORS only
        sel = np.nonzero(keep)[0]
        skeys = keys[sel]
        mats = [pres.count_matrix(tabs[o[i]:o[i + 1]], skeys
                                  ).astype(np.float64)
                for i in range(len(sizes))]

        pmw = self.get("p-value-mw")
        if pmw > 0 and len(sel):
            if self.N_GROUPS == 2:
                p = mannwhitney_p_rows(mats[0], mats[1])
                mw_pass = p <= pmw
            else:
                pab = mannwhitney_p_rows(mats[0], mats[1])
                pbc = mannwhitney_p_rows(mats[1], mats[2])
                pac = mannwhitney_p_rows(mats[0], mats[2])
                mw_pass = (pab < pmw) | (pbc < pmw) | (pac < pmw)
        else:
            mw_pass = np.ones(len(sel), dtype=bool)

        means = [m.mean(axis=1) for m in mats]
        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        outs = []
        if self.N_GROUPS == 2:
            to_a = mw_pass & (means[0] > means[1])
            masks = [to_a, mw_pass & ~to_a]
        else:
            to_a = mw_pass & (means[0] > means[1]) & (means[0] > means[2])
            to_b = (mw_pass & ~to_a & (means[1] > means[0])
                    & (means[1] > means[2]))
            masks = [to_a, to_b, mw_pass & ~to_a & ~to_b]
        for gi, mask in enumerate(masks):
            label = "ABC"[gi]
            fp = out_dir / f"filtered_group{label}.kmers.bin"
            _write_group_file(fp, skeys[mask], means[gi][mask])
            self.info(f"Total specific k-mers in Group {label} = "
                      f"{int(mask.sum())}")
            outs.append(str(fp))
        self.set_output("resulting-kmers-files", outs)


@register
class SpecificKmersTool(_SpecificKmersBase):
    NAME = "specific-kmers"
    DESCRIPTION = ("Output k-mers specific to each of two groups of samples "
                   "based on frequency chi-squared & Mann-Whitney tests")
    N_GROUPS = 2
    PARAMS = [
        Param("a-kmers", Path, "A", mandatory=True, multiple=True,
              description="k-mer files for group A"),
        Param("b-kmers", Path, "B", mandatory=True, multiple=True,
              description="k-mer files for group B"),
        Param("p-value-chi2", float, "pchi2", default=0.05,
              description="p-value for chi-squared test"),
        Param("p-value-mw", float, "pmw", default=0.05,
              description="p-value for Mann-Whitney test"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
    ]


@register
class SpecificKmers3Tool(_SpecificKmersBase):
    NAME = "specific-kmers-3"
    DESCRIPTION = ("Output k-mers specific to each of three groups of "
                   "samples based on frequency chi-squared & Mann-Whitney")
    N_GROUPS = 3
    PARAMS = [
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
        files = [f for g in groups for f in g]

        tabs = pres.LazyTables(files, b)
        keys = pres.union_keys(tabs)
        n1 = pres.group_presence_counts(tabs, keys, sizes)
        present = sum(n1)
        eligible = (present > math.ceil(total * 0.05)) & (present != total)

        if len(groups) == 2:
            stat = chisq_statistic2(sizes[0] - n1[0], n1[0],
                                    sizes[1] - n1[1], n1[1])
        else:
            stat = chisq_statistic3(sizes[0] - n1[0], n1[0],
                                    sizes[1] - n1[1], n1[1],
                                    sizes[2] - n1[2], n1[2])
        sel = np.nonzero(eligible)[0]
        stats_sel = stat[sel]
        # rank 0 = largest statistic (TopStatsKmersFinder.java:166-173)
        order = np.argsort(-stats_sel, kind="stable")
        ranks = np.empty(len(sel), dtype=np.int32)
        ranks[order] = np.arange(len(sel), dtype=np.int32)

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        n_best = self.get("num-kmers")
        all_file = out_dir / "all.kmers.bin"
        ranks_file = out_dir / "all_chi_squared_ranks.bin"
        top_file = out_dir / f"top_{n_best}_chi_squared_specific.kmers.bin"

        binfmt.write_kmers_bin(str(all_file), keys[sel],
                               np.ones(len(sel), dtype=np.int16))
        ranks_file.write_bytes(ranks.astype(">i4").tobytes())
        top = ranks < n_best
        binfmt.write_kmers_bin(str(top_file), keys[sel][top],
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

"""k-mer set algebra tools: unique-kmers, unique-kmers-multi, kmers-filter,
kmer-counter-posneg, on ``ctx.device``.

Counterpart of metafast_tpu/tools/filter_tools.py (:30-242); parity:
src/tools/UniqueKmersFinder.java, UniqueKmersMultipleSamplesFinder.java,
KmersFilter.java, KmersCounterPositiveNegative.java.
"""

from __future__ import annotations

from pathlib import Path

import torch

from .. import api
from ..graph.lookup import values_at
from ..io import binfmt, textfmt
from .framework import (ExecutionFailed, Param, Tool, check_k, host,
                        read_table, register, workdir_sub)
from .pipeline1 import KmerCounterManyTool


def _filter_keys(files, b: int, device: torch.device):
    """Keys with count > b of each filter file, one tensor per file."""
    for f in files:
        fk, fc = read_table(f, device)
        yield fk[fc > b]


def _last_per_key(keys: torch.Tensor, values: torch.Tensor):
    """Sorted unique keys, each with the value of its last occurrence:
    what numpy's ``a[idx] += v`` adds where idx repeats."""
    keys, order = torch.sort(keys, stable=True)
    keys, runs = torch.unique_consecutive(keys, return_counts=True)
    return keys, values[order][runs.cumsum(0) - 1]


@register
class UniqueKmersTool(Tool):
    NAME = "unique-kmers"
    DESCRIPTION = ("Output k-mers present in one group of samples and missing "
                   "in the other")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="input k-mer files (binary format)"),
        Param("filter-kmers", Path, mandatory=True, multiple=True,
              description="k-mer files used for filtering"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
        Param("stats-dir", Path, default=workdir_sub("stats")),
    ]

    def run_impl(self):
        check_k(self.get("k"))
        b = self.get("maximal-bad-frequency")
        dev = self.device
        keys, counts = api.load_kmers_bin(
            [str(f) for f in self.get("k-mers")], b, dev)

        # zero out keys present (> b) in any filter file
        # (UniqueKmersFinder.java:91-106)
        kill = torch.zeros_like(keys, dtype=torch.bool)
        for fk in _filter_keys(self.get("filter-kmers"), b, dev):
            kill |= torch.isin(keys, fk)
        counts = torch.where(kill, 0, counts)

        out_dir = self.get("output-dir")
        st_dir = self.get("stats-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        st_dir.mkdir(parents=True, exist_ok=True)
        good = counts > b
        out_file = out_dir / "filtered.kmers.bin"
        binfmt.write_kmers_bin(str(out_file), host(keys[good]),
                               host(counts[good]))
        textfmt.write_stat_txt(str(st_dir / "filtered.stat.txt"), counts)
        self.info(f"{len(keys)} k-mers found, {int(good.sum())} of them is "
                  f"good (present in one dataset and missing in other)")
        self.set_output("resulting-kmers-file", str(out_file))


@register
class UniqueKmersMultiTool(Tool):
    NAME = "unique-kmers-multi"
    DESCRIPTION = ("Output k-mers unique to a group of samples (present in "
                   "[min..max] samples, absent from the filter group)")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="input k-mer files (binary format)"),
        Param("filter-kmers", Path, mandatory=True, multiple=True,
              description="k-mer files used for filtering"),
        Param("min-samples", int, default=1,
              description="minimal number of samples k-mer to be present in"),
        Param("max-samples", int, default=1,
              description="maximal number of samples k-mer to be present in"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
        Param("stats-dir", Path, default=workdir_sub("stats")),
    ]

    def run_impl(self):
        check_k(self.get("k"))
        b = self.get("maximal-bad-frequency")
        dev = self.device
        if self.get("min-samples") > self.get("max-samples"):
            raise ExecutionFailed("--min-samples cannot be greater than "
                                  "--max-samples")

        # per-sample accumulation with Java short wrap-around on the sum
        # (UniqueKmersMultipleSamplesFinder.java:102-120: put((short)(a+v)))
        tables = []
        for f in self.get("k-mers"):
            fk, fc = read_table(f, dev)
            keep = fc > b
            tables.append((fk[keep], fc[keep]))
        keys = torch.unique(torch.cat([t[0] for t in tables]))
        sums = torch.zeros_like(keys)
        cnts = torch.zeros_like(keys)
        for fk, fc in tables:
            fk, fc = _last_per_key(fk, fc)
            idx = torch.searchsorted(keys, fk)
            sums.index_add_(0, idx, fc.to(torch.int64))
            cnts.index_add_(0, idx, torch.ones_like(idx))
        sums16 = sums.to(torch.int16)   # Java short cast semantics

        killed = torch.zeros_like(keys, dtype=torch.bool)
        for fk in _filter_keys(self.get("filter-kmers"), b, dev):
            killed |= torch.isin(keys, fk) & (sums16 > b)
        sums16 = torch.where(killed, 0, sums16)

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        self.get("stats-dir").mkdir(parents=True, exist_ok=True)

        out_files = []
        for i in range(self.get("min-samples"), self.get("max-samples") + 1):
            # value > b and sample count > i-1  (filterAndPrintKmers,
            # src/io/IOUtils.java:101-123)
            good = (sums16 > b) & (cnts > i - 1)
            out_file = out_dir / f"filtered_{i}.kmers.bin"
            binfmt.write_kmers_bin(str(out_file), host(keys[good]),
                                   host(sums16[good]))
            c = int(good.sum())
            self.info(f"{len(keys)} k-mers found, {c} of them is good "
                      f"(>= {i} samples)")
            out_files.append(str(out_file))
            if c == 0:
                self.info(f"No good k-mers found. Stop at maxSamples={i}")
                break
        self.set_output("resulting-kmers-files", out_files)
        self.set_output(
            "resulting-kmers-file",
            str(out_dir / f"filtered_{self.get('min-samples')}.kmers.bin"))


@register
class KmersFilterTool(Tool):
    NAME = "kmers-filter"
    DESCRIPTION = "Filter k-mers, leaving only k-mers from the filter set"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="input k-mer files (binary format)"),
        Param("filter-kmers", Path, mandatory=True, multiple=True,
              description="k-mer files used for filtering"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("max-thresh", int, default=0,
              description="maximal frequency for a k-mer in the filter "
                          "files to be assumed not found"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
        Param("stats-dir", Path, default=workdir_sub("stats")),
    ]

    def run_impl(self):
        check_k(self.get("k"))
        b = self.get("maximal-bad-frequency")
        dev = self.device
        filt_keys, filt_counts = api.load_kmers_bin(
            [str(f) for f in self.get("filter-kmers")], b, dev)
        thr = self.get("max-thresh") * len(self.get("filter-kmers"))

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        out_files = []
        for f in self.get("k-mers"):
            keys, counts = api.load_kmers_bin([str(f)], b, dev)
            fv = values_at(filt_keys, filt_counts, keys)
            good = (counts > b) & (fv > thr)
            name = Path(f).name.replace(".kmers.bin", "")
            out_file = out_dir / f"{name}.kmers.bin"
            binfmt.write_kmers_bin(str(out_file), host(keys[good]),
                                   host(counts[good]))
            self.info(f"{len(keys)} k-mers found, {int(good.sum())} of them "
                      f"survived after filtering")
            out_files.append(str(out_file))
        self.set_output("resulting-kmers-files", out_files)
        self.set_output("resulting-kmers-file",
                        out_files[0] if out_files else None)


@register
class KmerCounterPosNegTool(Tool):
    NAME = "kmer-counter-posneg"
    DESCRIPTION = ("Count k-mers in positive and negative groups of read "
                   "files")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("positiveReads", Path, "pos", mandatory=True, multiple=True,
              description="list of reads files from positive group"),
        Param("negativeReads", Path, "neg", mandatory=True, multiple=True,
              description="list of reads files from negative group"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("output-dir", Path, default=workdir_sub("kmers_posneg")),
    ]

    def run_impl(self):
        if not self.get("positiveReads") or not self.get("negativeReads"):
            raise ExecutionFailed("No libraries to process!")
        self._sub = {}
        for label, files in (("pos", self.get("positiveReads")),
                             ("neg", self.get("negativeReads"))):
            c = KmerCounterManyTool()
            c.set("k", self.get("k"))
            c.set("reads", files)
            c.set("maximal-bad-frequency", self.get("maximal-bad-frequency"))
            c.set("output-dir", self.workdir / label / "kmers")
            c.set("stats-dir", self.workdir / label / "stats")
            self.add_step(c)
            self._sub[label] = c

    def run(self, ctx, workdir=None):
        super().run(ctx, workdir)
        self.set_output("resulting-pos-kmers-files",
                        self._sub["pos"].outputs["resulting-kmers-files"])
        self.set_output("resulting-neg-kmers-files",
                        self._sub["neg"].outputs["resulting-kmers-files"])

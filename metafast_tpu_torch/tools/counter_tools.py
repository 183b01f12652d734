"""Sample-count tools: kmers-samples-counter, kmers-grouped-counter,
kmers-per-sample, kmers-multiple-filters.

Counterpart of metafast_tpu/tools/counter_tools.py (:45-222); parity:
src/tools/KmersSamplesCounter.java, KmersGroupedSamplesCounter.java,
KmersPerSampleCounter.java, KmersMultipleFilters.java.  The presence
counts and filter lookups run on ``ctx.device``; kmers-per-sample takes
the stats tools' device passes over its samples (``stats.presence``).
"""

from __future__ import annotations

from pathlib import Path

import torch

from .. import api
from ..graph.lookup import find, values_at
from ..io import binfmt, textfmt
from ..stats import presence as pres
from ..utils.kmers import kmers_strings
from .framework import (Param, Tool, check_k, host, read_table, register,
                        workdir_sub)


def _samples_count(keys: torch.Tensor, files, b: int) -> torch.Tensor:
    """#files in which each (sorted) key appears with count > b."""
    out = torch.zeros_like(keys)
    for f in files:
        fk, fc = read_table(f, keys.device)
        fk = torch.unique(fk[fc > b])
        idx, hit = find(keys, fk)
        rows = idx[hit]
        out.index_add_(0, rows, torch.ones_like(rows))
    return out


@register
class KmersSamplesCounterTool(Tool):
    NAME = "kmers-samples-counter"
    DESCRIPTION = "Count number of samples containing each k-mer"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="input k-mer files (one per sample)"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
        Param("stats-dir", Path, default=workdir_sub("stats")),
    ]

    def run_impl(self):
        check_k(self.get("k"))
        b = self.get("maximal-bad-frequency")
        files = self.get("k-mers")
        keys, _ = api.load_kmers_bin([str(f) for f in files], b, self.device)
        counts = _samples_count(keys, files, b)

        out_dir = self.get("output-dir")
        st_dir = self.get("stats-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        st_dir.mkdir(parents=True, exist_ok=True)
        out_file = out_dir / "n_samples.kmers.bin"
        good = counts > 0
        binfmt.write_kmers_bin(str(out_file), host(keys[good]),
                               host(counts[good].to(torch.int16)))
        textfmt.write_stat_txt(str(st_dir / "n_samples.stat.txt"), counts)
        self.info(f"{len(keys)} k-mers found, {int(good.sum())} good")
        self.set_output("resulting-kmers-file", str(out_file))


@register
class KmersGroupedCounterTool(Tool):
    NAME = "kmers-grouped-counter"
    DESCRIPTION = "Count per-group sample presence for each k-mer (3 groups)"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("kmers-file", Path, mandatory=True, multiple=True,
              description="k-mer files defining the key universe"),
        Param("cd-kmers", Path, mandatory=True, multiple=True,
              description="group 1 sample k-mer files"),
        Param("uc-kmers", Path, mandatory=True, multiple=True,
              description="group 2 sample k-mer files"),
        Param("nonibd-kmers", Path, mandatory=True, multiple=True,
              description="group 3 sample k-mer files"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
        Param("stats-dir", Path, default=workdir_sub("stats")),
    ]

    def run_impl(self):
        k = self.get("k")
        check_k(k)
        b = self.get("maximal-bad-frequency")
        keys, _ = api.load_kmers_bin(
            [str(f) for f in self.get("kmers-file")], 0, self.device)
        cd, uc, ni = (host(_samples_count(keys, self.get(g), b))
                      for g in ("cd-kmers", "uc-kmers", "nonibd-kmers"))

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        out_file = out_dir / "kmers.groups.txt"
        with open(out_file, "w") as fh:
            fh.write("Kmer\tcd_count\tuc_count\tnonibd_count\n")
            for s, a, bb, c in zip(kmers_strings(host(keys), k), cd, uc, ni):
                fh.write(f"{s}\t{a}\t{bb}\t{c}\n")
        self.info(f"K-mers printed to {out_file}")
        self.set_output("output-file", str(out_file))


@register
class KmersPerSampleCounterTool(Tool):
    NAME = "kmers-per-sample"
    DESCRIPTION = ("Table of per-sample abundances of k-mers present in "
                   "enough samples")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="input k-mer files (one per sample)"),
        Param("percent-present", int, "perc", default=20,
              description="output only k-mers present in at least this "
                          "percent of samples"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
    ]

    def run_impl(self):
        k = self.get("k")
        check_k(k)
        files = self.get("k-mers")
        tables = pres.LazyTables(files, 0, self.device)
        all_keys = pres.union_keys(tables)
        (n_present,) = pres.group_presence_counts(tables, all_keys,
                                                  [len(files)])
        thresh = len(files) * self.get("percent-present") // 100
        keys = all_keys[n_present >= thresh]

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        out_file = out_dir / f"selected_kmers_{self.get('percent-present')}.txt"
        counts = host(pres.count_matrix(tables, keys))
        with open(out_file, "w") as fh:
            fh.write("".join("\t" + s for s in kmers_strings(host(keys), k))
                     + "\n")
            for j, f in enumerate(files):
                name = Path(f).name.replace(".kmers.bin", "")
                fh.write(name
                         + "".join(f"\t{int(v)}" for v in counts[:, j])
                         + "\n")
        self.info(f"K-mers printed to {out_file}")
        self.set_output("output-file", str(out_file))


@register
class KmersMultipleFiltersTool(Tool):
    NAME = "kmers-multiple-filters"
    DESCRIPTION = "Compare sample k-mers against 3 weighted filter sets"
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="input k-mer files"),
        Param("cd-filter-kmers", Path, mandatory=True, multiple=True),
        Param("uc-filter-kmers", Path, mandatory=True, multiple=True),
        Param("nonibd-filter-kmers", Path, mandatory=True, multiple=True),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("output-dir", Path, default=workdir_sub("kmers")),
        Param("stats-dir", Path, default=workdir_sub("stats")),
    ]

    def run_impl(self):
        k = self.get("k")
        check_k(k)
        b = self.get("maximal-bad-frequency")
        dev = self.device
        filters = [api.load_kmers_bin([str(f) for f in self.get(name)], 0, dev)
                   for name in ("cd-filter-kmers", "uc-filter-kmers",
                                "nonibd-filter-kmers")]

        out_dir = self.get("output-dir")
        st_dir = self.get("stats-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        st_dir.mkdir(parents=True, exist_ok=True)

        out_files = []
        for f in self.get("k-mers"):
            keys, counts = api.load_kmers_bin([str(f)], b, dev)
            vals = torch.stack([values_at(fk, fc, keys) for fk, fc in filters])
            # stat over (cd, uc, nonibd) triples of all passing k-mers
            triples, n = torch.unique(vals.T, dim=0, return_counts=True)
            good = (vals > 0).any(0)

            name = Path(f).name.replace(".kmers.bin", "")
            out_file = out_dir / f"{name}.kmers.bin"
            st_file = st_dir / f"{name}.stat.txt"
            binfmt.write_kmers_bin(str(out_file), host(keys[good]),
                                   host(counts[good]))
            with open(st_file, "w") as fh:
                fh.write("# cd k-mer samples\tuc k-mer samples\t"
                         "nonIBD k-mer samples\tnumber of such k-mers\n")
                for (a, bb, c), m in zip(host(triples).tolist(),
                                         host(n).tolist()):
                    fh.write(f"{a}\t{bb}\t{c}\t{m}\n")
                fh.write("\n")
            self.info(f"{len(keys)} k-mers found, {int(good.sum())} survived "
                      f"after filtering")
            out_files.append(str(out_file))
        self.set_output("resulting-kmers-files", out_files)

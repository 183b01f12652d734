"""Colored k-mer tools: kmers-color, component-colored.

Counterpart of metafast_tpu/tools/colored_tools.py (:21-135); parity:
src/tools/ColorKmersMain.java, ColoredComponentMain.java.  Host NumPy
and the native traversal, as in the JAX package.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..graph import colored as col
from ..io import binfmt, textfmt
from .framework import ExecutionFailed, Param, Tool, register, workdir_sub

@register
class ColorKmersTool(Tool):
    NAME = "kmers-color"
    DESCRIPTION = "Count k-mer occurrences per class (packed 3x20-bit colors)"
    PARAMS = [
        Param("k", int, "k", default=31, description="k-mer size"),
        Param("kmers-files", Path, "kf", mandatory=True, multiple=True,
              description="list of input files with k-mers in binary format"),
        Param("class", Path, mandatory=True,
              description="tab-separated file: sample_name<TAB>class [0|1|2]"),
        Param("maximal-bad-frequency", int, "b", default=1,
              description="maximal frequency for an erroneous k-mer"),
        Param("val", bool, default=False,
              description="count total coverage instead of number of samples"),
        Param("output-dir", Path, "o", default=workdir_sub("colored-kmers"),
              description="Output directory"),
    ]

    def run_impl(self):
        b = self.get("maximal-bad-frequency")
        file2color = {}
        for line in Path(self.get("class")).read_text().splitlines():
            if line.strip():
                name, c = line.split("\t")[:2]
                file2color[name] = int(c)

        acc: dict = {}
        packed_keys = np.empty(0, dtype=np.int64)
        packed_vals = np.empty(0, dtype=np.int64)
        for f in self.get("kmers-files"):
            name = Path(f).name
            if name.endswith(".kmers.bin"):
                name = name[:-len(".kmers.bin")]
            if name not in file2color:
                raise ExecutionFailed(f"sample {name!r} missing in class file")
            color = file2color[name]
            keys, counts = binfmt.read_kmers_bin(str(f))
            keep = counts > b
            keys, counts = keys[keep], counts[keep]
            add = counts.astype(np.int64) if self.get("val") else \
                np.ones(len(keys), dtype=np.int64)

            allk = np.unique(np.concatenate([packed_keys, keys]))
            newv = np.zeros(len(allk), dtype=np.int64)
            newv[np.searchsorted(allk, packed_keys)] = packed_vals
            idx = np.searchsorted(allk, keys)
            newv[idx] = col.add_value(newv[idx], color, add)
            packed_keys, packed_vals = allk, newv

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        out_file = out_dir / "colored_kmers.kmers.bin"
        st_file = out_dir / "colored_kmers.stat.txt"
        binfmt.write_long_kmers_bin(str(out_file), packed_keys, packed_vals)
        textfmt.write_stat_txt(str(st_file), packed_vals)
        self.info(f"{len(packed_keys)} colored k-mers printed to {out_file}")
        self.set_output("colored-kmers-file", str(out_file))


@register
class ColoredComponentTool(Tool):
    NAME = "component-colored"
    DESCRIPTION = "Extract color-specific components from colored k-mers"
    PARAMS = [
        Param("k", int, "k", default=31, description="k-mer size"),
        Param("k-mers", Path, "i", mandatory=True, multiple=True,
              description="input files with colored k-mers in binary format"),
        Param("n_groups", int, "group", default=3,
              description="number of classes"),
        Param("separate", bool, default=False,
              description="use only color-specific k-mers in components"),
        Param("linear", bool, default=False,
              description="choose best path on fork (linear components)"),
        Param("n_comps", int, "comp", default=-1,
              description="max components per class (-1 = all)"),
        Param("perc", float, default=0.9,
              description="relative abundance to become color-specific"),
        Param("output-dir", Path, "o",
              default=workdir_sub("colored-components"),
              description="Output directory"),
    ]

    def run_impl(self):
        keys_all, vals_all = [], []
        for f in self.get("k-mers"):
            ks, vs = binfmt.read_long_kmers_bin(str(f))
            keys_all.append(ks)
            vals_all.append(vs)
        keys = np.concatenate(keys_all)
        vals = np.concatenate(vals_all)

        comps = col.split_colored(
            keys, vals, self.get("k"), n_groups=self.get("n_groups"),
            separate=self.get("separate"), linear=self.get("linear"),
            n_comps=self.get("n_comps"), perc=self.get("perc"),
            device=self.device)

        out_dir = self.get("output-dir")
        out_dir.mkdir(parents=True, exist_ok=True)
        total = 0
        stat_fp = self.workdir / "components-stat.txt"
        with open(stat_fp, "w") as fh:
            fh.write("# component.no\tcomponent.size\tcomponent.weight"
                     "\tcomponent.color\n")
            for color, comp_list in sorted(comps.items()):
                self.info(f"{len(comp_list)} components were found for "
                          f"class {color}")
                out_file = out_dir / f"components_color_{color}.bin"
                binfmt.write_components_bin(
                    str(out_file), [(c.kmers, c.weight) for c in comp_list])
                for c in comp_list:
                    total += 1
                    fh.write(f"{total}\t{c.size}\t{c.weight}\t{color}\n")
        self.info(f"Total {total} components were found")
        self.set_output("components-stat", str(stat_fp))
        self.set_output("output-dir", str(out_dir))

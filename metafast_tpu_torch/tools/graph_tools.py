"""comp2graph: components -> de Bruijn unitig graph in GFA format.

Counterpart of metafast_tpu/tools/graph_tools.py (:18-73); parity:
src/tools/ComponentsToGraph.java.  The coverage lookups run on
``ctx.device``; the GFA text comes from the JAX package's jax-free
``graph.gfa``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from metafast_tpu.graph.gfa import component_gfa
from metafast_tpu.io import binfmt

from .. import api
from ..graph.lookup import find, values_at
from .framework import Param, Tool, check_k, host, read_table, register


@register
class ComponentsToGraphTool(Tool):
    NAME = "comp2graph"
    DESCRIPTION = ("Transforms components in binary format to de Bruijn "
                   "graph in GFA format")
    PARAMS = [
        Param("k", int, "k", mandatory=True, description="k-mer size"),
        Param("components-file", Path, "cf", mandatory=True,
              description="binary components file"),
        Param("k-mers", Path, "i", multiple=True,
              description="k-mer files for graph coverage"),
        Param("coverage", bool, "cov", default=False,
              description="coverage = total occurrences instead of number "
                          "of samples (only with -i)"),
        Param("graph-file", Path,
              default=lambda t: (t.workdir or Path(".")) /
              "components-graph.gfa",
              description="file to write the graph to"),
    ]

    def run_impl(self):
        k = self.get("k")
        check_k(k)
        dev = self.device
        comps = binfmt.read_components_bin(str(self.get("components-file")))
        self.info(f"{len(comps)} components loaded")

        cov_keys = cov_vals = None
        if self.get("k-mers"):
            files = [str(f) for f in self.get("k-mers")]
            cov_keys, cov_vals = api.load_kmers_bin(files, 0, dev)
            if not self.get("coverage"):
                # number of samples containing the k-mer
                cov_vals = torch.zeros_like(cov_keys)
                for f in files:
                    fk, _fc = read_table(f, dev)
                    idx, _ = find(cov_keys, torch.unique(fk))
                    cov_vals.index_add_(0, idx, torch.ones_like(idx))

        out = self.get("graph-file")
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as fh:
            for icomp, (kmers, _w) in enumerate(comps):
                if cov_keys is not None:
                    weights = host(values_at(cov_keys, cov_vals,
                                             torch.from_numpy(kmers).to(dev)))
                else:
                    weights = np.ones(len(kmers), dtype=np.int64)
                fh.write(component_gfa(kmers, weights, k, icomp))
        self.info("Graph components saved to GFA format!")
        self.set_output("graph-file", str(out))

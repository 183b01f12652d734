"""metafast-tpu on PyTorch: the default matrix-builder pipeline on a CUDA GPU.

A second package beside the JAX one (``metafast_tpu``), with the same
module names so each piece has an obvious counterpart:

  api.count_reads_files     per-sample canonical k-mer counting
  ops.stream_extract        stream extraction (hand CUDA kernel, csrc/)
  ops.count.KmerCounter     sort + run-length reduce + saturating merge
  graph.lookup / dbg        sorted-table lookups, de Bruijn neighbor tables
  graph.contigs             simple-path contigs (Wyllie pointer doubling)
  graph.components          size-window component splitting (hooking)
  pipeline.matrix           features + Bray-Curtis, the whole pipeline
  cli                       ``python -m metafast_tpu_torch.cli``

Keys are int64 (k <= 31 keeps them below 2**62) with INT64_MAX as the
"no k-mer" sentinel.  Every public entry takes an explicit ``device``;
"cuda" raises when there is no GPU, and "cpu" runs the plain PyTorch
versions of the kernels.  The package imports torch and never jax; of the
JAX package it uses only the jax-free host modules (the native C++
parser and stream builders, the text/binary formats, the oracle).
"""

__version__ = "0.1.0"

"""metafast-tpu on PyTorch: the matrix-builder pipeline and tools on a CUDA GPU.

A second package beside the JAX one (``metafast_tpu``), with the same
module names so each piece has an obvious counterpart:

  api.count_reads_files     per-sample canonical k-mer counting (FASTA,
                            FASTQ, BINQ)
  ops.stream_extract        stream extraction (hand CUDA kernel, csrc/)
  core.extract              padded read-batch extraction (torch ops)
  ops.count.KmerCounter     sort + run-length reduce + saturating merge,
                            host spill
  ops.psort                 blocked bitonic sort (hand CUDA kernel, csrc/)
  graph.lookup / dbg        sorted-table lookups, de Bruijn neighbor tables
  graph.contigs             simple-path contigs (Wyllie pointer doubling)
  graph.components          size-window component splitting (hooking)
  pipeline.matrix           features + Bray-Curtis, the whole pipeline
  io                        the file formats and read parsers
  tools                     step framework and the ported tools
  cli                       ``python -m metafast_tpu_torch.cli -t <tool>``

Keys are int64 (k <= 31 keeps them below 2**62) with INT64_MAX as the
"no k-mer" sentinel.  Every public entry takes an explicit ``device``;
"cuda" raises when there is no GPU, and "cpu" runs the plain PyTorch
versions of the kernels.  The package imports torch and never jax, and
nothing of the JAX package: it keeps its own copies of the host modules
it needs (native/ with the C++ parser and stream builders, io/, the
k-mer, progress, GFA, heatmap and presence helpers) under the same names.
"""

__version__ = "0.1.0"

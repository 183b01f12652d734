"""The on-disk formats and read parsers, shared with the JAX package.

These are the JAX package's jax-free modules (``metafast_tpu.io``):
``binfmt`` (.kmers.bin, components.bin), ``textfmt`` (stat,
distribution, vectors, matrices, contig FASTA) and ``reads`` (FASTA,
FASTQ, BINQ).  Code that names no module of the JAX package
(``chip_smoke.py``) reaches them here.
"""

from metafast_tpu.io import binfmt, reads, textfmt  # noqa: F401

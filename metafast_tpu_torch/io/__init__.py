"""The on-disk formats and read parsers.

The port's copies of the JAX package's jax-free modules
(``metafast_tpu.io``), under the same names: ``binfmt`` (.kmers.bin,
components.bin), ``textfmt`` (stat, distribution, vectors, matrices,
contig FASTA), ``reads`` (FASTA, FASTQ, BINQ) and ``native_reads`` (the
C++ parser into padded batches).
"""

from . import binfmt, reads, textfmt  # noqa: F401

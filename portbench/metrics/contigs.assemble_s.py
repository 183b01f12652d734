"""contigs.assemble_s: mean seconds a job spends assembling ranked chains
into contigs on the host (the program's `contigs.assemble` spans,
graph/contigs._assemble), inside its seq-builder-many step."""

from portbench.harness.spans import span_mean


def read(rec):
    return span_mean(rec, "contigs.assemble", "seq-builder-many")

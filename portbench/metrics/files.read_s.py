"""files.read_s: mean seconds a job spends reading its step files back
(every `read.*` span of the program: .kmers.bin, the contig FASTA,
components.bin, .vec)."""

from portbench.harness.spans import span_mean


def read(rec):
    return span_mean(rec, "read.")

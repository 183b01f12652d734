"""files.write_s: mean seconds a job spends writing its step files (every
`write.*` span of the program: .kmers.bin, stat.txt, distribution,
.seq.fasta, components.bin and its stat file, .vec and .breadth, the
matrix), the copies to the host before them left out."""

from portbench.harness.spans import span_mean


def read(rec):
    return span_mean(rec, "write.")

"""counting.parse_s: mean seconds a job spends in the native parse of its
read files (the program's `count.parse` spans, api.parse_reads), inside
its kmer-counter-many step."""

from portbench.harness.spans import span_mean


def read(rec):
    return span_mean(rec, "count.parse", "kmer-counter-many")

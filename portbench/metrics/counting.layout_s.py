"""counting.layout_s: mean seconds a job spends packing its reads into the
3-stream layout and uploading them through pinned memory (the program's
`count.layout` spans, api.count_codes), inside its kmer-counter-many
step."""

from portbench.harness.spans import span_mean


def read(rec):
    return span_mean(rec, "count.layout", "kmer-counter-many")

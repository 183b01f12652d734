"""counting.merge_s: mean seconds a job spends counting and merging raw
keys (the program's `count.merge` spans: KmerCounter._consolidate when a
chunk fills, and ops.count.device_table), inside its kmer-counter-many
step.  The sorts end on a host read of their length, so this holds their
device time."""

from portbench.harness.spans import span_mean


def read(rec):
    return span_mean(rec, "count.merge", "kmer-counter-many")

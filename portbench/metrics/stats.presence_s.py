"""stats.presence_s: mean seconds a job spends building the union of both
groups' keys and each group's presence counts over it (the program's
`stats.presence.*` spans, stats/presence), inside its stats-kmers step."""

from portbench.harness.named_spans import named_span_mean


def read(rec):
    return named_span_mean(rec, "stats.presence.", "stats-kmers")

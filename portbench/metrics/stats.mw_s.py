"""stats.mw_s: mean seconds a job spends on the chi-squared survivors'
count matrices, their depth normalisation, the Mann-Whitney test and the
split by group mean (the program's `stats.mw` span), inside its
stats-kmers step."""

from portbench.harness.named_spans import named_span_mean


def read(rec):
    return named_span_mean(rec, "stats.mw", "stats-kmers")

"""stats.chi2_s: mean seconds a job spends on the scarce and in-all masks,
the chi-squared statistic and the selection of its survivors (the
program's `stats.chi2` span), inside its stats-kmers step."""

from portbench.harness.named_spans import named_span_mean


def read(rec):
    return named_span_mean(rec, "stats.chi2", "stats-kmers")

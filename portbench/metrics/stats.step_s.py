"""stats.step_s: mean seconds of a job's stats-kmers step (presence over the
union of both groups' tables, the chi-squared test, Mann-Whitney on the
survivors, the selection files), from the launcher's "done in" record."""


def read(rec):
    return rec.step_mean("stats-kmers")

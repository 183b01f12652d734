"""stats.ns_per_key: nanoseconds of a job's stats-kmers step per union key
it tests (the step's "done in" record over the program's `stats_keys`
counter, both a job)."""

from portbench.harness.spans import counter_mean_gb


def read(rec):
    step = rec.step_mean("stats-kmers")
    keys = counter_mean_gb(rec, "stats_keys")      # in 10^9 keys a job
    if step is None or not keys:
        return None
    return step / keys

"""components.bookkeeping_s: mean seconds a job spends in the host NumPy of
split_components' levels: compaction, grouping by label, the size window
(the program's `components.bookkeeping` spans), inside its
component-cutter step."""

from portbench.harness.spans import span_mean


def read(rec):
    return span_mean(rec, "components.bookkeeping", "component-cutter")

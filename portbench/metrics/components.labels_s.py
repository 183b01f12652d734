"""components.labels_s: mean seconds a job spends on the device labels of
split_components' levels: neighbour tables, the labeller and the labels'
copy to the host (the program's `components.labels` spans), inside its
component-cutter step."""

from portbench.harness.spans import span_mean


def read(rec):
    return span_mean(rec, "components.labels", "component-cutter")

"""extract.step_s: mean seconds of a job's component-extractor step (the
graph and pivot tables loaded, the neighbour index, the traversal from
the pivots, components.bin), from the launcher's "done in" record."""


def read(rec):
    return rec.step_mean("component-extractor")

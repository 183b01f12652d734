"""components.step_s: mean seconds of a job's component-cutter step (the
contig recount, split_components' labels and host bookkeeping,
components.bin), from the launcher's "done in" record."""


def read(rec):
    return rec.step_mean("component-cutter")

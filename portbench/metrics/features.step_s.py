"""features.step_s: mean seconds of a job's features-calculator and
dist-matrix-calculator steps (feature vectors, Bray-Curtis and their
writers), from the launcher's "done in" records."""


def read(rec):
    return rec.step_mean("features-calculator", "dist-matrix-calculator")

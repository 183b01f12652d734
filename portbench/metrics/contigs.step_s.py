"""contigs.step_s: mean seconds of a job's seq-builder-many step (table
load, neighbour tables, chain ranking, host assembly, the FASTA writer),
from the launcher's "done in" record."""


def read(rec):
    return rec.step_mean("seq-builder-many")

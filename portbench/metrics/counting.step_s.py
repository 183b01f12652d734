"""counting.step_s: mean seconds of a job's kmer-counter-many step (parse,
layout and upload, K1, sort and merge, the .kmers.bin writer), from the
launcher's "done in" record."""


def read(rec):
    return rec.step_mean("kmer-counter-many")

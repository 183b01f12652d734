"""files.written_GB: mean bytes of step files a job writes (the program's
`written_bytes` counter: the sizes of the files its write spans name,
summed over the traced window), in 10^9 bytes."""

from portbench.harness.spans import counter_mean_gb


def read(rec):
    return counter_mean_gb(rec, "written_bytes")

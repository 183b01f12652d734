"""device.h2d_GB: mean bytes a job copies from the host to the device (the
program's `h2d_bytes` counter, summed over the traced window), in
10^9 bytes."""

from portbench.harness.spans import counter_mean_gb


def read(rec):
    return counter_mean_gb(rec, "h2d_bytes")

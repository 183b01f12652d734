"""device.d2h_GB: mean bytes a job copies from the device to the host (the
program's `d2h_bytes` counter, summed over the traced window), in
10^9 bytes."""

from portbench.harness.spans import counter_mean_gb


def read(rec):
    return counter_mean_gb(rec, "d2h_bytes")

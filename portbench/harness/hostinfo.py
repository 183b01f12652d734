"""Lines for noise diagnosis: the card's clocks and power, the host's
load, and the bytes this process wrote."""

from __future__ import annotations

import shutil
import subprocess
import time

import numpy as np

QUERY = ("name,power.limit,power.draw,clocks.sm,clocks.mem,"
         "temperature.gpu,utilization.gpu")


def card_line(label: str) -> str:
    if shutil.which("nvidia-smi") is None:
        return f"card {label}: nvidia-smi not found"
    out = subprocess.run(["nvidia-smi", f"--query-gpu={QUERY}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=30)
    return f"card {label} ({QUERY}): {out.stdout.strip() or out.stderr.strip()}"


def loadavg_line(label: str) -> str:
    with open("/proc/loadavg") as fh:
        return f"loadavg {label}: {fh.read().strip()}"


def written_line() -> str:
    """This process's write counters (/proc/self/io): bytes passed to
    write(), bytes sent to storage, and writes cancelled by deletion."""
    with open("/proc/self/io") as fh:
        io = dict(line.split(": ") for line in fh.read().splitlines())
    return ("bytes written: wchar={} write_bytes={} "
            "cancelled_write_bytes={}".format(
                io["wchar"].strip(), io["write_bytes"].strip(),
                io["cancelled_write_bytes"].strip()))


def host_probe_line(label: str) -> str:
    """Seconds for a fixed host task (sorting 2^22 int64 keys drawn from
    a fixed seed): the host's speed beside the window."""
    keys = np.random.default_rng(0).integers(0, 2**62, 1 << 22)
    t0 = time.perf_counter()
    np.sort(keys)
    return f"host probe {label}: sort_2^22_s={time.perf_counter() - t0:.6f}"

"""Console progress with ETA.

Parity intent: the reference's Progress tree + in-place '\\r' console line
(itmo utils/tool/Progress.java:11-75, Tool.java:1134-1171) and the
dispatcher's periodic read-count logging (src/io/ReadsDispatcher.java:40-51).
"""

from __future__ import annotations

import sys
import time


class Progress:
    """In-place progress line: `prefix  done/total (pct)  ETA mm:ss`."""

    def __init__(self, total: int | None, prefix: str = "",
                 stream=None, min_interval: float = 0.2,
                 enabled: bool | None = None):
        self.total = total
        self.prefix = prefix
        self.stream = stream or sys.stderr
        self.min_interval = min_interval
        self.t0 = time.time()
        self._last = 0.0
        self._done = 0
        self.enabled = (self.stream.isatty() if enabled is None else enabled)

    def update(self, done: int | None = None, add: int = 0) -> None:
        if done is not None:
            self._done = done
        else:
            self._done += add
        now = time.time()
        if not self.enabled or now - self._last < self.min_interval:
            return
        self._last = now
        line = f"\r{self.prefix} {self._done:,}"
        if self.total:
            frac = self._done / self.total
            line += f"/{self.total:,} ({frac * 100:.1f}%)"
            if 0 < frac < 1:
                eta = (now - self.t0) * (1 - frac) / frac
                line += f"  ETA {int(eta // 60):d}:{int(eta % 60):02d}"
        self.stream.write(line + "   ")
        self.stream.flush()

    def close(self, message: str | None = None) -> None:
        if self.enabled:
            self.stream.write("\r" + " " * 70 + "\r")
            if message:
                self.stream.write(message + "\n")
            self.stream.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CountingProgress:
    """Counting-path progress: inline console line + periodic log lines.

    Parity: the reference's dispatcher logs every 2.5M reads with map
    sizes (src/io/ReadsDispatcher.java:40-51) and renders an in-place
    console progress line (itmo utils/tool/Tool.java:1134-1171).  The
    callable signature matches api.count_reads_files's ``progress`` hook:
    one dict with keys path/reads/kmers.
    """

    def __init__(self, logger=None, every_reads: int = 2_500_000,
                 line: Progress | None = None):
        self.logger = logger
        self.every = every_reads
        self._next = every_reads
        self.line = Progress(None, prefix="reads") if line is None else line

    def __call__(self, info: dict) -> None:
        reads = int(info.get("reads", 0))
        self.line.update(done=reads)
        if self.logger is not None and reads >= self._next:
            self._next = (reads // self.every + 1) * self.every
            self.logger.info(
                "processed %s reads from %s, ~%s k-mers so far (mem: %s)",
                f"{reads:,}", info.get("path", "?"),
                f"{int(info.get('kmers', 0)):,}", memory_used_str())

    def close(self) -> None:
        self.line.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def memory_used_str() -> str:
    """Resident memory as a human string (reference Misc.usedMemoryAsString)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS"):
                    kb = int(line.split()[1])
                    return f"{kb / 1048576:.2f} GB" if kb > 1048576 else \
                        f"{kb / 1024:.1f} MB"
    except OSError:
        pass
    return "?"

"""One run of a cell: set-up, the measured window, the check, the result.

Set-up generates the cell's reads from the seed into a fresh directory
under TMPDIR and runs one warm-up job, which builds and loads every
kernel and library the jobs use.  The window then runs whole launcher
jobs (``metafast_tpu_torch.cli.main`` in this process) one after
another, each in a fresh work dir, and starts none once ``seconds``
have passed; the job in flight finishes and ends the window.  After the
window the device peak is read, the program's state freed, and the
cell's tool module (portbench/tools) judges every job's outputs against
its plain reference (portbench/reference).
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from ..gen.community import generate
from . import compare, hostinfo, steplog
from . import trace as tracing
from .cells import Cell

FORBIDDEN = ("jax", "jaxlib", "flax", "metafast_tpu")


@dataclass
class Job:
    workdir: Path
    rc: int
    wall_s: float
    wall_start: float           # epoch seconds
    k1_launches: int
    steps: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)


@dataclass
class Record:
    """What the per-layer metric readers read (portbench/metrics)."""
    jobs: list[Job]
    window_s: float
    peak_bytes: int
    trace: tracing.TraceSummary | None = None
    k1_words: list = field(default_factory=list)    # (n_words, layout)

    def step_mean(self, *names: str) -> float | None:
        done = [j for j in self.jobs if j.rc == 0 and j.steps]
        if not done:
            return None
        return sum(sum(j.steps.get(n, 0.0) for n in names)
                   for j in done) / len(done)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: metafast_tpu_torch is not metafast_tpu)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class _K1Shapes:
    """Records the words of each K1 launch on the card (the bytes it must
    move follow from them), around the program's own launch counter."""

    def __init__(self, se):
        self.se, self.orig, self.words = se, se.stream_extract, []

    def __enter__(self):
        orig, words = self.orig, self.words

        def recorded(w0, w1, w2, vm, k, layout="stream3"):
            out = orig(w0, w1, w2, vm, k, layout)
            if w0.device.type == "cuda":
                words.append((w0.numel(), layout))
            return out

        recorded.launches = orig.launches
        self.se.stream_extract = recorded
        return self

    def __exit__(self, *exc):
        self.orig.launches = self.se.stream_extract.launches
        self.se.stream_extract = self.orig


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float | None = None,
        log=print) -> dict:
    """The result line of one run (see run.py); ``checks`` last."""
    from metafast_tpu_torch import cli
    from metafast_tpu_torch.ops import stream_extract as se

    t_start = time.time() if t_start is None else t_start
    tool = cell.tool
    base = Path(tempfile.mkdtemp(prefix="portbench-"))
    devnull = open(os.devnull, "w")
    try:
        t_gen = time.perf_counter()
        samples = generate(cell.traffic, seed, base / "reads")
        log(f"generated {len(samples)} samples in "
            f"{time.perf_counter() - t_gen:.3f} s, "
            f"{sum(os.path.getsize(f) for s in samples for f in s.files)} "
            f"bytes of FASTQ")
        files = [f for s in samples for f in s.files]
        names = sorted(s.name for s in samples)

        def one_job(wd: Path) -> tuple[int, float, float, int]:
            n0 = se.stream_extract.launches
            wall0, t0 = time.time(), time.perf_counter()
            with contextlib.redirect_stderr(devnull):
                try:
                    rc = cli.main(tool.argv(cell.config, files, wd, device))
                except Exception as e:  # a job that raises has failed
                    log(f"job in {wd} raised {type(e).__name__}: {e}")
                    rc = 1
            _sync(device)
            return (rc, time.perf_counter() - t0, wall0,
                    se.stream_extract.launches - n0)

        warm = one_job(base / "warmup")
        shutil.rmtree(base / "warmup", ignore_errors=True)
        log(f"warm-up job: rc={warm[0]} wall_s={warm[1]:.6f} "
            f"k1_launches={warm[3]}")
        log(hostinfo.card_line("before window"))
        log(hostinfo.loadavg_line("before window"))
        log(hostinfo.host_probe_line("before window"))

        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        prof = shapes = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts, acc_events=True)
            shapes = _K1Shapes(se)
            prof.__enter__()
            shapes.__enter__()
        jobs: list[Job] = []
        t_window = time.perf_counter()
        setup_s = time.time() - t_start
        with torch.profiler.record_function("portbench.window"):
            while True:
                wd = base / f"job{len(jobs)}"
                with torch.profiler.record_function(
                        f"portbench.job{len(jobs)}"):
                    rc, wall, wall0, n_k1 = one_job(wd)
                jobs.append(Job(wd, rc, wall, wall0, n_k1))
                if time.perf_counter() - t_window >= seconds:
                    break
        window_s = time.perf_counter() - t_window
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
        summary = None
        if trace:
            shapes.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            path = base / "trace.json"
            prof.export_chrome_trace(str(path))
            del prof
        for j in jobs:
            log_path = j.workdir / "log"
            if log_path.exists():
                j.spans = steplog.spans(log_path)
                j.steps = steplog.step_seconds(j.spans)
        if trace:
            summary = tracing.summarize(
                path, [(j.wall_start, j.spans) for j in jobs])
        log(hostinfo.card_line("after window"))
        log(hostinfo.loadavg_line("after window"))
        log(hostinfo.host_probe_line("after window"))
        for i, j in enumerate(jobs):
            log(f"job {i}: rc={j.rc} wall_s={j.wall_s:.6f} "
                f"k1_launches={j.k1_launches} steps="
                + " ".join(f"{k}={v:.3f}" for k, v in j.steps.items()))

        # the check: the program's state freed, the reference on the device
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        stages: dict = {}
        want = tool.expected(samples, cell.config["params"], device, stages)
        ref_s = time.perf_counter() - t_ref
        log("reference stages: " + " ".join(f"{k}={v:.3f}"
                                            for k, v in stages.items()))
        readings, failed = [], 0
        for j in jobs:
            got = None
            if j.rc == 0:
                try:
                    got = tool.read_job(j.workdir, names)
                except (OSError, ValueError) as e:
                    log(f"job {j.workdir.name}: unreadable outputs: {e}")
            if got is None:
                failed += 1
            else:
                readings.append(tool.compare(got, want))
            shutil.rmtree(j.workdir, ignore_errors=True)
        numbers = compare.worst(readings, tool.LIMITS)
        log(f"reference_s={ref_s:.3f} jobs={len(jobs)} failed={failed} "
            + tool.summary(want))
    finally:
        shutil.rmtree(base, ignore_errors=True)
        devnull.close()
    log(hostinfo.written_line())
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {', '.join(found)}")

    done = len(jobs) - failed
    rec = Record(jobs, window_s, peak, summary,
                 shapes.words if shapes else [])
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = m.read(rec)
            if v is not None:
                metrics[m.name] = {"value": v, "unit": m.unit}
    else:
        metrics = {"job_s": {"value": window_s / max(done, 1), "unit": "s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": failed == 0 and compare.passed(numbers,
                                                        tool.LIMITS),
              "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = {k: {"value": v, "limit": tool.LIMITS[k]}
                        for k, v in numbers.items()}
    return result


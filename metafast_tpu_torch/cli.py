"""Command-line runner: ``python -m metafast_tpu_torch.cli [-t tool] [options]``.

Counterpart of metafast_tpu/cli.py (:1-217), the reference launcher
(src/Runner.java, itmo Runner.java:191-208, metafast.sh): ``-t`` selects a
registered tool (default matrix-builder), ``--tools`` lists the registry,
per-tool options come from the tool's declared parameters, and the run is
checkpointed under ``--work-dir``.

``--gui`` runs the interactive wizard (``gui.py``).

``--shards n`` (n > 1) runs the tool as n ranks of one process group
(``parallel.distributed.launch``), each a process running this same
command in lockstep: ``cuda:<rank>`` over NCCL with ``--device cuda``, the
CPU over gloo with ``--device cpu``.  Counting and component labels run
over the mesh; the other stages, contig ranking among them, run
replicated.
Only rank 0 logs to the console and writes the work dir the user named;
the others write into a temporary work dir removed at exit, and follow
rank 0's ``--continue`` / ``--start`` decisions (tools/framework.py).
The exit code is the worst of the ranks', and a failing rank stops the
others.

Where it departs from the JAX launcher:
  - ``--device cuda|cpu`` (default cuda) names the device every tool runs
    on; cuda without a GPU is an error, never a CPU run; the wizard
    passes it on to the run it starts;
  - a JAX mesh lives in one process, so ``--shards`` there needs no
    launcher; ``--shards`` above the GPU count exits 1 with ``--device
    cuda`` as in JAX, while ``--device cpu`` takes any n;
  - a device out-of-memory error (``torch.cuda.OutOfMemoryError``) maps to
    advice that fits one device.
"""

from __future__ import annotations

import contextlib
import logging
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import __version__
from . import api
from .parallel import distributed as D
from .tools import framework as fw  # the package import registers the tools
from .utils.device import resolve_device

DEFAULT_TOOL = "matrix-builder"


def _print_tools() -> None:
    print("Available tools:")
    for name, cls in fw.all_tools().items():
        print(f"  {name:28s} {cls.DESCRIPTION}")


def _print_help(tool_cls) -> None:
    t = tool_cls()
    print(f"Tool: {tool_cls.NAME}")
    print(tool_cls.DESCRIPTION)
    print("\nInput parameters:")
    for p in t.PARAMS:
        opts = (f"-{p.short} " if p.short else "") + f"--{p.name}"
        d = ("mandatory" if p.mandatory else
             f"default: {p.default_comment or p.default}")
        print(f"  {opts:36s} {p.description} [{d}]")
    print("\nLaunch options:")
    print("  -w --work-dir    working directory (default: workDir)")
    print("  -c --continue    continue the previous run (checkpointed steps)")
    print("     --force       rewrite the working directory")
    print("     --device DEV  device to run on: cuda or cpu (default: cuda)")
    print("     --shards N    run as N ranks, one device each (cuda: one GPU "
          "a rank)")
    print("     --start NAME  start from this step")
    print("     --finish NAME stop after this step")
    print("  -v --verbose     enable debug output")
    print("  -h --help        this help")


def _setup_logging(workdir: Path, verbose: bool,
                   console_level: int = logging.NOTSET) -> logging.Logger:
    logger = logging.getLogger(fw.LOGGER)
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)-5s %(message)s")
    con = logging.StreamHandler()
    con.setLevel(console_level)
    con.setFormatter(fmt)
    logger.addHandler(con)
    workdir.mkdir(parents=True, exist_ok=True)
    (workdir / "logs").mkdir(exist_ok=True)
    ts = time.strftime("%Y-%m-%d_%H-%M-%S")
    for fp in (workdir / "log", workdir / "logs" / f"log_{ts}"):
        fh = logging.FileHandler(fp, mode="a")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def parse_args(argv: list[str]):
    """Hand-rolled parser: tool params are dynamic, values may be lists
    and may be negative numbers."""
    tool_name = None
    opts: dict[str, list[str] | bool] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("-"):
            raise SystemExit(f"unexpected positional argument: {a}")
        key = a.lstrip("-")
        vals: list[str] = []
        i += 1
        while i < len(argv) and not (argv[i].startswith("-")
                                     and not _is_number(argv[i])):
            vals.append(argv[i])
            i += 1
        if key in ("t", "tool"):
            tool_name = vals[0] if vals else None
            continue
        opts[key] = vals if vals else True
    return tool_name, opts


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _scalar(v):
    if isinstance(v, list):
        return v[0]
    return v


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    if not argv or argv in (["-h"], ["--help"]):
        print(f"Fast metagenome analysis toolkit (PyTorch), version "
              f"{__version__}\n")
        print("Usage:  python -m metafast_tpu_torch.cli [<Launch options>] "
              "[<Input parameters>]")
        print(f"Default tool: {DEFAULT_TOOL}; use --tools to list all tools, "
              f"-t <tool> -h for tool help.")
        return 0
    if "--version" in argv:
        print(f"metafast-tpu (PyTorch) version {__version__}")
        return 0
    if "--tools" in argv:
        _print_tools()
        return 0
    if "--gui" in argv:
        from .gui import run_wizard
        return run_wizard([a for a in argv if a != "--gui"])

    tool_name, opts = parse_args(argv)
    shards = opts.pop("shards", None)
    if shards is not None and int(_scalar(shards)) > 1:
        return _launch_shards(argv, int(_scalar(shards)), opts)
    try:
        tool_cls = fw.get_tool(tool_name or DEFAULT_TOOL)
    except KeyError as e:
        print(f"ERROR: {e.args[0]}", file=sys.stderr)
        return 1

    if opts.pop("h", None) or opts.pop("help", None):
        _print_help(tool_cls)
        return 0

    try:
        device = resolve_device(str(_scalar(opts.pop("device", "cuda"))))
    except (RuntimeError, ValueError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    workdir = Path(str(_scalar(opts.pop("w", opts.pop("work-dir", ["workDir"])))))
    ranked = D.rank_from_env()
    if ranked is None:
        return _run_tool(tool_cls, opts, device, workdir)
    with _as_rank(ranked, device, workdir) as (device, own, console):
        mirror = None if own == workdir else workdir
        return _run_tool(tool_cls, opts, device, own, console, mirror)


def _run_tool(tool_cls, opts: dict, device: torch.device, workdir: Path,
              console_level: int = logging.NOTSET,
              mirror: Path | None = None) -> int:
    """Run one tool with the launch options left in ``opts`` (``mirror``:
    rank 0's work dir, on a rank above 0 of a --shards run)."""
    cont = bool(opts.pop("c", False) or opts.pop("continue", False))
    force = bool(opts.pop("force", False))
    start = opts.pop("start", None)
    finish = opts.pop("finish", None)
    verbose = bool(opts.pop("v", False) or opts.pop("verbose", False))
    # accepted and ignored, as by the JAX launcher: thread count, memory
    for key in ("p", "available-processors", "m", "memory", "ea", "eta"):
        opts.pop(key, None)

    logger = _setup_logging(workdir, verbose, console_level)
    ctx = fw.RunContext(workdir=workdir, cont=cont, force=force,
                        start=_scalar(start) if start else None,
                        finish=_scalar(finish) if finish else None,
                        verbose=verbose, device=device, logger=logger,
                        desc_files=[workdir / "output_description.txt"],
                        mirror=mirror)

    tool = tool_cls()
    # map remaining options onto tool params (short or long)
    by_short = {p.short: p for p in tool.PARAMS if p.short}
    by_long = {p.name: p for p in tool.PARAMS}
    for key, val in opts.items():
        p = by_short.get(key) or by_long.get(key)
        if p is None:
            # the reference's commons-cli parser errors on unrecognized
            # options (Tool.java:626-659); a typo must not silently run
            # the whole pipeline with defaults
            logger.error("unknown option --%s for tool '%s' (see -t %s -h)",
                         key, tool.NAME, tool.NAME)
            return 1
        if p.type is bool:
            tool.set(p.name, True)
        elif p.multiple:
            tool.set(p.name, [p.type(v) for v in (val if isinstance(val, list) else [val])])
        else:
            v = val[0] if isinstance(val, list) else val
            tool.set(p.name, p.type(v))

    logger.info("running on %s", device)
    try:
        tool.run(ctx)
    except fw.ExecutionFailed as e:
        logger.error("%s", e)
        return 1
    except (MemoryError, torch.cuda.OutOfMemoryError) as e:
        logger.error("out of memory: %s", str(e).splitlines()[0] if str(e)
                     else type(e).__name__)
        logger.error(_OOM_ADVICE)
        return 1
    except Exception:  # uncaught-failure UX parity (Tool.java:572-585)
        logger.exception("unexpected failure in tool '%s'", tool.NAME)
        logger.error("this looks like a bug; the full traceback is in "
                     "%s", workdir / "log")
        return 1
    return 0


def _without_shards(argv: list[str]) -> list[str]:
    """argv with its --shards option and value taken out."""
    out, skip = [], False
    for a in argv:
        if a.lstrip("-") == "shards" and a.startswith("-"):
            skip = True
            continue
        if skip and not (a.startswith("-") and not _is_number(a)):
            continue
        skip = False
        out.append(a)
    return out


def _launch_shards(argv: list[str], n: int, opts: dict) -> int:
    """``--shards n``: n ranks of this command (parallel.distributed)."""
    device = str(_scalar(opts.get("device", "cuda")))
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if n > have:
            print(f"ERROR: --shards {n} exceeds available devices ({have})")
            return 1
    return D.launch(_without_shards(argv), n)


@contextlib.contextmanager
def _as_rank(ranked, device: torch.device, workdir: Path):
    """One rank of a ``--shards`` run: join the group and set the default
    mesh; yields (the rank's device, its work dir, its console log
    level).  Ranks above 0 work in a temporary work dir, removed at exit,
    and log only errors to the console."""
    rank, world, store = ranked
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
    mesh = D.initialize(world, rank, store, device.type)
    api.set_default_mesh(mesh)
    scratch = None if rank == 0 else tempfile.mkdtemp(prefix="metafast-rank-")
    try:
        if scratch is None:
            yield mesh.device, workdir, logging.NOTSET
        else:
            yield mesh.device, Path(scratch), logging.ERROR
    finally:
        api.set_default_mesh(None)
        D.shutdown()
        if scratch is not None:
            shutil.rmtree(scratch, ignore_errors=True)


_OOM_ADVICE = (
    "the run exceeded available memory. Try: (1) run fewer samples per "
    "call (each sample is counted on its own; the later steps hold the "
    "union of all samples' contig k-mers), (2) split large input files, "
    "or (3) raise the k-mer frequency threshold -b to shrink the tables. "
    "(Reference equivalent: increase -m, Tool.java:532-564.)")


if __name__ == "__main__":
    raise SystemExit(main())

"""Command-line runner: ``python -m metafast_tpu_torch.cli [-t tool] [options]``.

Counterpart of metafast_tpu/cli.py (:1-217), the reference launcher
(src/Runner.java, itmo Runner.java:191-208, metafast.sh): ``-t`` selects a
registered tool (default matrix-builder), ``--tools`` lists the registry,
per-tool options come from the tool's declared parameters, and the run is
checkpointed under ``--work-dir``.

``--gui`` runs the interactive wizard (``gui.py``).

Where it departs from the JAX launcher:
  - ``--device cuda|cpu`` (default cuda) names the device every tool runs
    on; cuda without a GPU is an error, never a CPU run; the wizard
    passes it on to the run it starts;
  - ``--shards`` exits 1: multi-device counting is not ported yet;
  - a device out-of-memory error (``torch.cuda.OutOfMemoryError``) maps to
    advice that fits one device.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path

import torch

from . import __version__
from .tools import framework as fw  # the package import registers the tools
from .utils.device import resolve_device

DEFAULT_TOOL = "matrix-builder"
NOT_PORTED = ("shards",)


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
    print("     --start NAME  start from this step")
    print("     --finish NAME stop after this step")
    print("  -v --verbose     enable debug output")
    print("  -h --help        this help")


def _setup_logging(workdir: Path, verbose: bool) -> logging.Logger:
    logger = logging.getLogger(fw.LOGGER)
    logger.setLevel(logging.DEBUG if verbose else logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)-5s %(message)s")
    con = logging.StreamHandler()
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
    for key in NOT_PORTED:
        if key in opts:
            print(f"ERROR: --{key} is not ported yet", file=sys.stderr)
            return 1
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
    cont = bool(opts.pop("c", False) or opts.pop("continue", False))
    force = bool(opts.pop("force", False))
    start = opts.pop("start", None)
    finish = opts.pop("finish", None)
    verbose = bool(opts.pop("v", False) or opts.pop("verbose", False))
    # accepted and ignored, as by the JAX launcher: thread count, memory
    for key in ("p", "available-processors", "m", "memory", "ea", "eta"):
        opts.pop(key, None)

    logger = _setup_logging(workdir, verbose)
    ctx = fw.RunContext(workdir=workdir, cont=cont, force=force,
                        start=_scalar(start) if start else None,
                        finish=_scalar(finish) if finish else None,
                        verbose=verbose, device=device, logger=logger,
                        desc_files=[workdir / "output_description.txt"])

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


_OOM_ADVICE = (
    "the run exceeded available memory. Try: (1) run fewer samples per "
    "call (each sample is counted on its own; the later steps hold the "
    "union of all samples' contig k-mers), (2) split large input files, "
    "or (3) raise the k-mer frequency threshold -b to shrink the tables. "
    "(Reference equivalent: increase -m, Tool.java:532-564.)")


if __name__ == "__main__":
    raise SystemExit(main())

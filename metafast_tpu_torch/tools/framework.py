"""Tool framework: declarative parameters, step composition, checkpointing.

Counterpart of metafast_tpu/tools/framework.py (:1-345), with the same
semantics (reference: itmo ru/ifmo/genetics/utils/tool/Tool.java,
Parameter.java, ParameterDescription.java):

  - a Tool declares typed Params (short opt, default value or lazy
    default, importance, description); the CLI and the composite wiring
    both read this declaration
  - composite tools add sub-steps; each step runs in its own
    ``workdir/<step-name>/`` with a JSON manifest of inputs/outputs and a
    SUCCESS marker (Tool.java:31-33,318-392)
  - ``--continue`` skips a step iff SUCCESS exists and every recorded
    input equals the current one (Tool.java:758-795); ``--force``
    rewrites; ``--start``/``--finish`` bound the run by step name
    (Tool.java:485-529)
  - every step appends its outputs to ``output_description.txt``
    (src/io/IOUtils.java:217-231)

One addition: ``RunContext.device``, the torch device every tool runs on.
It is a launch option, not a tool Param, so the declared parameters, the
``-h`` text and the manifests' ``inputs`` are the JAX package's.
"""

from __future__ import annotations

import json
import logging
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from ..io import binfmt
from ..utils.device import resolve_device

LOGGER = "metafast_torch"


class ExecutionFailed(Exception):
    pass


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

@dataclass
class Param:
    """One declared tool parameter (reference: ParameterDescription)."""
    name: str                      # long option, e.g. "maximal-bad-frequency"
    type: type = str               # int, float, bool, str, Path
    short: str | None = None       # short option, e.g. "b"
    default: Any = None            # value or callable(tool) -> value
    mandatory: bool = False
    multiple: bool = False         # space-separated list of values
    important: bool = False
    description: str = ""
    default_comment: str | None = None

    @property
    def attr(self) -> str:
        return self.name.replace("-", "_")


# ---------------------------------------------------------------------------
# Run context
# ---------------------------------------------------------------------------

@dataclass
class RunContext:
    workdir: Path
    cont: bool = False
    force: bool = False
    start: str | None = None
    finish: str | None = None
    verbose: bool = False
    processors: int = 0
    device: str | torch.device = "cuda"
    logger: logging.Logger = field(
        default_factory=lambda: logging.getLogger(LOGGER))
    desc_files: list[Path] = field(default_factory=list)
    _started: bool = field(default=False)  # for --start gating


SUCCESS = "SUCCESS"
MANIFEST = "manifest.json"


def _jsonable(v):
    if isinstance(v, Path):
        return str(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


# ---------------------------------------------------------------------------
# Tool
# ---------------------------------------------------------------------------

class Tool:
    NAME: str = ""
    DESCRIPTION: str = ""
    PARAMS: list[Param] = []

    def __init__(self, **values):
        self.values: dict[str, Any] = {}
        self.outputs: dict[str, Any] = {}
        self.steps: list[Tool] = []
        self.ctx: RunContext | None = None
        self.workdir: Path | None = None
        for k, v in values.items():
            self.set(k, v)

    # -- parameter access ---------------------------------------------------

    def param(self, name: str) -> Param:
        for p in self.PARAMS:   # instance attr if rebound, else class attr
            if p.name == name or p.attr == name:
                return p
        raise KeyError(f"{self.NAME}: unknown parameter {name!r}")

    def set(self, name: str, value: Any) -> None:
        self.values[self.param(name).name] = value

    def get(self, name: str) -> Any:
        p = self.param(name)
        if p.name in self.values:
            v = self.values[p.name]
        else:
            v = p.default(self) if callable(p.default) else p.default
        if v is None and p.mandatory:
            raise ExecutionFailed(
                f"{self.NAME}: mandatory parameter --{p.name} not set")
        if v is not None and p.type is Path and not isinstance(v, Path):
            if p.multiple:
                v = [Path(x) for x in v]
            else:
                v = Path(v)
        return v

    @property
    def device(self) -> torch.device:
        """The run's device; "cuda" without a GPU raises."""
        return resolve_device(self.ctx.device if self.ctx else "cuda")

    # -- logging ------------------------------------------------------------

    def _logger(self) -> logging.Logger:
        return self.ctx.logger if self.ctx else logging.getLogger(LOGGER)

    def info(self, msg: str) -> None:
        self._logger().info("[%s] %s", self.NAME, msg)

    def debug(self, msg: str) -> None:
        self._logger().debug("[%s] %s", self.NAME, msg)

    def warn(self, msg: str) -> None:
        self._logger().warning("[%s] %s", self.NAME, msg)

    # -- outputs ------------------------------------------------------------

    def set_output(self, name: str, value: Any) -> None:
        self.outputs[name] = value

    def describe_output(self, path, text: str) -> None:
        """Append to output_description.txt (IOUtils.java:217-231)."""
        if not self.ctx:
            return
        for f in self.ctx.desc_files:
            try:
                with open(f, "a") as fh:
                    fh.write(f"{path}\n   {text}\n\n")
            except OSError:
                pass

    # -- composition --------------------------------------------------------

    def add_step(self, tool: "Tool") -> "Tool":
        self.steps.append(tool)
        return tool

    # -- execution ----------------------------------------------------------

    def run_impl(self) -> None:
        raise NotImplementedError

    def _input_record(self) -> dict:
        rec = {}
        for p in self.PARAMS:
            try:
                rec[p.name] = _jsonable(self.get(p.name))
            except ExecutionFailed:
                rec[p.name] = None
        return rec

    def run(self, ctx: RunContext, workdir: Path | None = None) -> None:
        """Run this tool (and its steps) under ``workdir``."""
        self.ctx = ctx
        self.workdir = Path(workdir) if workdir else ctx.workdir
        if workdir is None:
            # top-level invocation: refuse to clobber a workdir holding
            # previous run state unless told how (reference prompts
            # "rewrite workDir?" interactively, Tool.java:407-433; we are
            # flag-based: --continue resumes, --force rewrites)
            self._guard_existing_state()
        self.workdir.mkdir(parents=True, exist_ok=True)

        t0 = time.perf_counter()
        self.info("started")
        self.run_impl()
        self._run_steps()
        self.info("done in %.3fs" % (time.perf_counter() - t0))

    def _guard_existing_state(self) -> None:
        ctx = self.ctx
        # --start inherently implies prior state (it resumes from a step),
        # so it passes the guard like --continue does
        if ctx.cont or ctx.force or ctx.start or not self.workdir.is_dir():
            return
        prior = sorted(str(p.parent.relative_to(self.workdir))
                       for p in self.workdir.glob(f"*/{SUCCESS}"))
        if prior:
            raise ExecutionFailed(
                f"working directory '{self.workdir}' contains state from a "
                f"previous run (steps: {', '.join(prior)}); pass --continue "
                f"to resume it or --force to overwrite it")

    def _step_in_range(self, name: str) -> bool:
        ctx = self.ctx
        if ctx.start and not ctx._started:
            if name == ctx.start or name.startswith(ctx.start + "."):
                ctx._started = True
            else:
                return False
        return True

    def _step_dirs(self) -> list[Path]:
        """Unique per-step dirs: repeated step names get _2, _3, ... suffixes."""
        seen: dict[str, int] = {}
        dirs = []
        for step in self.steps:
            seen[step.NAME] = seen.get(step.NAME, 0) + 1
            n = seen[step.NAME]
            dirs.append(self.workdir /
                        (step.NAME if n == 1 else f"{step.NAME}_{n}"))
        return dirs

    def _run_steps(self) -> None:
        ctx = self.ctx
        for step, sd in zip(self.steps, self._step_dirs()):
            if not self._step_in_range(step.NAME):
                # before --start: load recorded outputs so later steps work
                self._load_step_outputs(step, sd)
                ctx.logger.info("[%s] skipped (before --start)", step.NAME)
                continue
            if self._can_skip(step, sd) and step.NAME != ctx.start:
                # the named --start step always reruns, even with an
                # up-to-date manifest: starting *from* it is the request
                self._load_step_outputs(step, sd)
                ctx.logger.info("[%s] up to date, skipped", step.NAME)
            else:
                if sd.exists() and not ctx.cont:
                    shutil.rmtree(sd, ignore_errors=True)
                sd.mkdir(parents=True, exist_ok=True)
                step.run(ctx, sd)
                self._write_manifest(step, sd)
            if ctx.finish and step.NAME == ctx.finish:
                # invalidate the next step's stale SUCCESS (Tool.java:514-527)
                i = self.steps.index(step)
                if i + 1 < len(self.steps):
                    nxt = self.workdir / self.steps[i + 1].NAME / SUCCESS
                    if nxt.exists():
                        nxt.unlink()
                ctx.logger.info("stopping after --finish=%s", step.NAME)
                break

    def _can_skip(self, step: "Tool", sd: Path) -> bool:
        ctx = self.ctx
        if ctx.force or not ctx.cont:
            return False
        if not (sd / SUCCESS).exists() or not (sd / MANIFEST).exists():
            return False
        # lazy defaults (workdir-relative paths) must see the step's dir
        step.ctx = ctx
        step.workdir = sd
        try:
            rec = json.loads((sd / MANIFEST).read_text())
        except (OSError, json.JSONDecodeError):
            return False
        return rec.get("inputs") == _jsonable(step._input_record())

    def _write_manifest(self, step: "Tool", sd: Path) -> None:
        rec = {"tool": step.NAME,
               "inputs": step._input_record(),
               "outputs": _jsonable(step.outputs)}
        (sd / MANIFEST).write_text(json.dumps(rec, indent=1))
        (sd / SUCCESS).write_text("")

    def _load_step_outputs(self, step: "Tool", sd: Path) -> None:
        try:
            rec = json.loads((sd / MANIFEST).read_text())
        except (OSError, json.JSONDecodeError):
            return
        step.outputs = rec.get("outputs", {})
        step.ctx = self.ctx
        step.workdir = sd


def late_bind(tool: Tool, param: str, thunk: Callable[[], Any]) -> None:
    """Bind a tool parameter to a value produced by an earlier step.

    The reference wires InValue suppliers between sub-tools
    (DistanceMatrixBuilderMain.java:88-146); here a late-bound default
    reads the predecessor's recorded outputs at execution time, which
    also works when the predecessor was skipped via --continue.
    """
    p = tool.param(param)
    idx = tool.PARAMS.index(p)
    tool.PARAMS = list(tool.PARAMS)
    tool.PARAMS[idx] = Param(p.name, p.type, p.short,
                             default=lambda t: thunk(),
                             mandatory=False, multiple=p.multiple,
                             description=p.description)


def workdir_sub(name: str):
    """Lazy default: ``name`` under the tool's working directory."""
    return lambda tool: (tool.workdir or Path(".")) / name


def check_k(k: int) -> None:
    if not (1 <= k <= 31):
        raise ExecutionFailed("The size of k-mer must be in [1, 31].")


def host(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host, for the file writers."""
    return t.cpu().numpy()


def read_table(path, device: torch.device):
    """A .kmers.bin file as it stands (keys int64, counts int32), on
    ``device``."""
    keys, counts = binfmt.read_kmers_bin(str(path))
    return torch.from_numpy(keys).to(device), torch.from_numpy(counts).to(device)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, type[Tool]] = {}


def register(cls: type[Tool]) -> type[Tool]:
    if not cls.NAME:
        raise ValueError(f"{cls} has no NAME")
    _REGISTRY[cls.NAME] = cls
    return cls


def get_tool(name: str) -> type[Tool]:
    if name not in _REGISTRY:
        raise KeyError(f"unknown tool {name!r}; see --tools")
    return _REGISTRY[name]


def all_tools() -> dict[str, type[Tool]]:
    return dict(sorted(_REGISTRY.items()))

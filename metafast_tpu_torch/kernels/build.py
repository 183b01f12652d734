"""Build the hand CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher and is
compiled by nvcc for sm_90a into ``build/kernels/`` at the root of the
checkout (git-ignored), keyed on a hash of the source and the flags, so a
fresh checkout builds what it runs; nvcc's ``-Xptxas -v`` report
(registers, shared memory and spills of each kernel) is kept beside the
library as ``<name>-<hash>.log`` (``build_log``).  A missing nvcc or a
failed build raises: there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is built."""
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and load it."""
    out = _library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {name}.cu:"
                               f"\n{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def build_log(name: str) -> str:
    """nvcc's output for the built ``csrc/<name>.cu`` ("" if not kept)."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""

"""Build & load the native parsing library via ctypes (no pip needed).

``fastparse.cpp`` is compiled with the system g++ at first use into
``build/native/`` at the root of the checkout (git-ignored), keyed on a
hash of the source and the flags, as kernels/build.py keys the CUDA
kernels.  A missing or failing g++ raises: the port has no NumPy
fallback for the parser and stream builders.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "fastparse.cpp"
BUILD_DIR = _HERE.parent.parent / "build" / "native"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]


def library_path() -> Path:
    """Where the shared library of ``fastparse.cpp`` is built."""
    h = hashlib.sha256(_SRC.read_bytes()
                       + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"fastparse-{h}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not build {_SRC.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) on {_SRC.name}:"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load_library():
    """The loaded ctypes library; raises if it cannot be built."""
    lib = ctypes.CDLL(str(_build()))
    i64 = ctypes.c_int64
    p8 = ctypes.POINTER(ctypes.c_uint8)
    p32 = ctypes.POINTER(ctypes.c_int32)
    p64 = ctypes.POINTER(ctypes.c_int64)
    lib.parse_fasta.restype = i64
    lib.parse_fasta.argtypes = [p8, i64, p8, i64, p32, i64, p64, p64]
    lib.parse_fastq.restype = i64
    lib.parse_fastq.argtypes = [p8, i64, ctypes.c_int32, p8, i64, p32,
                                i64, p64, p64]
    lib.extract_canonical.restype = i64
    lib.extract_canonical.argtypes = [p8, p32, i64, ctypes.c_int32, p64,
                                      i64]
    lib.pack_batch.restype = None
    lib.pack_batch.argtypes = [p8, p64, i64, ctypes.c_int32, p8, i64]
    pu32 = ctypes.POINTER(ctypes.c_uint32)
    lib.build_stream_cols.restype = None
    lib.build_stream_cols.argtypes = [p8, i64, p32, i64, ctypes.c_int32,
                                      pu32, pu32, i64]
    pu64 = ctypes.POINTER(ctypes.c_uint64)
    pu16 = ctypes.POINTER(ctypes.c_uint16)
    lib.count_kmers_baseline.restype = i64
    lib.count_kmers_baseline.argtypes = [p8, p32, i64, ctypes.c_int32,
                                         pu64, pu16, ctypes.c_int32, p64]
    lib.build_stream3_cols.restype = None
    lib.build_stream3_cols.argtypes = [p8, i64, p32, i64,
                                       ctypes.c_int32, pu32, pu32,
                                       pu32, pu32, i64]
    pi8 = ctypes.POINTER(ctypes.c_int8)
    lib.colored_bfs.restype = i64
    lib.colored_bfs.argtypes = [p32, pi8, i64, ctypes.c_int32,
                                ctypes.c_int32, i64, p32, i64, p64,
                                p32, i64]
    lib.pivot_bfs_depth1.restype = i64
    lib.pivot_bfs_depth1.argtypes = [p32, p32, p64, p8, i64, p64, i64,
                                     p32, i64, p64, p64, p64, i64]
    lib.contig_walk_baseline.restype = i64
    lib.contig_walk_baseline.argtypes = [pu64, p32, i64, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_int32,
                                         p64, p64]
    lib.bfs_components_baseline.restype = i64
    lib.bfs_components_baseline.argtypes = [pu64, p32, i64,
                                            ctypes.c_int32,
                                            ctypes.c_int32, p64]
    return lib

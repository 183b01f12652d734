"""The native host library (parser, stream builders, baselines).

The port shares the JAX package's jax-free C++ library
(metafast_tpu/native/fastparse.cpp, built with g++ at first use).  The
JAX package falls back to NumPy packers when it cannot be built; the
port has no such fallback and raises.
"""

from __future__ import annotations

from metafast_tpu.native import load_library


def native_library():
    """The loaded ctypes library; raises if it cannot be built."""
    lib = load_library()
    if lib is None:
        raise RuntimeError(
            "native library metafast_tpu/native/fastparse.cpp could not be "
            "built (is g++ installed?)")
    return lib

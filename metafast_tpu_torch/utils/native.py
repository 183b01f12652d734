"""The native host library (parser, stream builders, baselines).

The port's own copy of the C++ library (native/fastparse.cpp, built with
g++ at first use into build/native/).  The JAX package falls back to
NumPy packers when it cannot be built; the port has no such fallback and
raises.
"""

from __future__ import annotations

from ..native import load_library


def native_library():
    """The loaded ctypes library; raises if it cannot be built."""
    return load_library()

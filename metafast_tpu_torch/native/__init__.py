"""Native (C++) host components, built on demand with the system g++.

Counterpart of metafast_tpu/native.  The compiled library goes into
``build/native/`` at the root of the checkout; a failed build raises.
"""

from .build import load_library  # noqa: F401

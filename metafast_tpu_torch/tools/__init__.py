"""Tool registry: importing this package registers the ported tools.

Counterpart of metafast_tpu/tools/__init__.py.  Ported so far: the
matrix-builder chain, heatmap-maker, the k-mer filters, the sample
counters, the converters and comp2graph (23 of the JAX package's 39
tools).
"""

from . import (composite, convert, counter_tools, filter_tools,  # noqa: F401
               graph_tools, pipeline1)

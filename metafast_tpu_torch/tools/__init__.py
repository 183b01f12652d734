"""Tool registry: importing this package registers the tools.

Counterpart of metafast_tpu/tools/__init__.py: all 39 of the JAX
package's tools, from the same eleven modules.
"""

from . import (colored_tools, composite, composite2,  # noqa: F401
               convert, counter_tools, extract_tools, filter_tools,
               graph_tools, misc_tools, pipeline1, stats_tools)

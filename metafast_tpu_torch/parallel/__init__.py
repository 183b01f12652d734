"""Multi-device paths over ``torch.distributed``: one rank per device.

Counterpart of metafast_tpu/parallel/: ``distributed`` (process group,
mesh, exact exchange, the ``--shards`` launcher), ``count`` (hash-sharded
k-mer counting), ``contigs`` (sharded pointer doubling) and
``components`` (sharded star contraction).
"""

from .count import make_mesh, sharded_count  # noqa: F401

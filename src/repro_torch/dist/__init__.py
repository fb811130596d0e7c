"""Distributed execution layer: placement rules over mesh shapes.

``repro_torch.dist.sharding`` is the consumer of the co-optimization
search's placement knobs: the ARCO shard-space tuner
(``repro_torch.launch.autotune``) emits a ``ShardingRules``, and the
dry-run estimator (``repro_torch.launch.dryrun``) prices the placements it
gives.  Meshes here are shapes (axis name -> size); building a
``DeviceMesh`` over real devices is the multi-process step builders' job.
"""
from repro_torch.dist.sharding import (  # noqa: F401
    NamedSharding,
    ShardingRules,
    axis_size,
    batch_sharding,
    batch_specs,
    cache_shardings,
    data_axes,
    fit_axes,
    param_shardings,
)

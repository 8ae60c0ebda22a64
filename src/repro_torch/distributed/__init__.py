"""Sharded execution on a ``torch.distributed`` ``DeviceMesh``: the logical-axis
rules as DTensor placements (``sharding``) and the int8 cross-pod gradient
sum (``compression``), the JAX package's ``distributed/``."""
from .sharding import (  # noqa: F401
    AxisRules, DEFAULT_LM_RULES, get_mesh, get_rules, logical_sharding, mesh_context,
    set_mesh, shard_hint,
)

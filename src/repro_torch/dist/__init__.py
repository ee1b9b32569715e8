"""Distribution layer of the port: the sharding policy over a
``torch.distributed`` ``DeviceMesh`` (``policy.py``) and the collectives
of the mesh paths (``collectives.py``). The reference's ``compat.py``
shims adapt JAX's API alone and have no twin (PORT.md, "Multi-GPU").
Importing this package touches no process group and no device."""

from repro_torch.dist.policy import (NO_SHARDING, ShardingPolicy, lm_rules,
                                     shard_rank)

__all__ = ["NO_SHARDING", "ShardingPolicy", "lm_rules", "shard_rank"]

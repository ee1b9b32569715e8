"""ShardingPolicy: the one object that carries "how is this run sharded"
(port of ``src/repro/dist/policy.py``).

The policy is a ``torch.distributed`` ``DeviceMesh`` (or None) and a dict
of named layout rules. Each rule is a tuple with one entry per dimension,
as ``tuple(PartitionSpec)`` gives it: None (replicated), an axis name, or
a tuple of two or more axis names (one axis is its bare name, none is
None); ``()`` is the fully replicated ``P()``.

  * single-device (``NO_SHARDING``): ``sharding`` is None and
    ``constrain`` the identity, as in the reference;
  * under a mesh: the RkMIPS engine shards its user rows and the forward
    scan its item rows over every mesh axis (``engine/sharding.py``),
    one process per rank (SPMD), in the order ``shard_rank`` gives.
    Pinning a named activation or parameter layout (``sharding`` and
    ``constrain`` of a rule the policy has) is model parallelism, which
    waits for slice 16 of the port's multi-GPU work and raises.

Rule names are the reference's closed vocabulary (DESIGN.md SS5):
act_btd, act_attn_in, act_bhsd, act_btf, logits, kv_cache for the
activations, p_embed, p_head, p_norm, p_attn_in/out, p_mlp_in/out,
p_router, p_expert_in/out for the LM parameters (per-layer specs start
with None for the stacked (L,) axis). ``lm_rules`` builds the TP/SP set
or, with ``pure_dp=True``, the ZeRO-1-style pure data-parallel set.

Importing this module touches no process group and no device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

# Mesh axes that act as batch ("data-parallel") axes anywhere in the stack.
# launch/mesh.py builds ("data", "model") and ("pod", "data", "model").
DP_AXIS_NAMES = ("pod", "data")
TP_AXIS_NAME = "model"

# the mesh work still to port, named in the NotImplementedError it raises
MODEL_SLICE = ("the multi-GPU slice 16 of the port (model parallelism "
               "under a mesh)")


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """A ``DeviceMesh`` + named layout rules; the unit of sharding
    injection. ``mesh=None`` makes every method the no-op or identity.
    ``group`` is the process group the mesh paths' collectives run on:
    None for the default group, or a group over the same ranks (the
    serving runtime gives its off-thread compaction one of its own, so
    that it never interleaves with the dispatches)."""

    mesh: Any = None          # torch.distributed.device_mesh.DeviceMesh
    rules: Mapping[str, tuple] = dataclasses.field(default_factory=dict)
    group: Any = None         # torch.distributed.ProcessGroup or None

    # -- rule lookup -------------------------------------------------------

    def spec(self, name: str) -> tuple | None:
        """The layout rule registered under ``name`` (None if absent)."""
        return self.rules.get(name)

    def sharding(self, name: str):
        """None when unsharded or the rule is unknown; a rule under a mesh
        waits for model parallelism and raises."""
        if self.mesh is None or name not in self.rules:
            return None
        raise NotImplementedError(
            f"ShardingPolicy.sharding({name!r}) under a mesh waits for "
            f"{MODEL_SLICE}")

    def constrain(self, x, name: str):
        """Pin ``x`` to the layout of rule ``name``: the identity without
        a mesh or for an unknown name, as in the reference."""
        self.sharding(name)          # raises for a rule under a mesh
        return x

    # -- mesh geometry -----------------------------------------------------

    def _names(self) -> tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names or ())

    def dp_axes(self) -> tuple[str, ...]:
        """Mesh axes that shard the batch dimension, in mesh order."""
        if self.mesh is None:
            return ()
        return tuple(a for a in DP_AXIS_NAMES if a in self._names())

    def axis_size(self, axis: str) -> int:
        if self.mesh is None or axis not in self._names():
            return 1
        return int(self.mesh.size(self._names().index(axis)))

    @property
    def dp_size(self) -> int:
        size = 1
        for a in self.dp_axes():
            size *= self.axis_size(a)
        return size

    @property
    def model_axis_size(self) -> int:
        """Size of the tensor/model-parallel axis (1 without a mesh)."""
        return self.axis_size(TP_AXIS_NAME)

    @property
    def device_count(self) -> int:
        """Total rank count of the mesh (1 without a mesh): the shard
        count of anything row-sharded over every mesh axis (the RkMIPS
        engine's user and item rows, the build's row-parallel stages)."""
        if self.mesh is None:
            return 1
        return int(self.mesh.size())


NO_SHARDING = ShardingPolicy(mesh=None, rules={})


def shard_rank(policy: ShardingPolicy) -> int:
    """This process's shard of anything row-sharded over every mesh axis:
    its rank's flat position in the mesh, row-major over the mesh dims,
    which is the order JAX tiles ``P(axes)`` over all axes. 0 without a
    mesh."""
    if policy is None or policy.mesh is None:
        return 0
    import torch.distributed as dist
    ranks = policy.mesh.mesh.flatten().tolist()
    return ranks.index(dist.get_rank())


def rank_device(policy: ShardingPolicy) -> torch.device:
    """The device this rank computes on under ``policy``'s mesh: for a
    "cuda" mesh ``cuda:{rank % device_count}`` (ranks beyond the cards of
    a host share them), else the mesh's device type."""
    import torch.distributed as dist
    kind = policy.mesh.device_type
    if kind == "cuda":
        return torch.device("cuda", dist.get_rank()
                            % torch.cuda.device_count())
    return torch.device(kind)


def _axes_tuple(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def _spec(*entries) -> tuple:
    """A rule with ``PartitionSpec``'s normal form of each entry."""
    def one(e):
        if isinstance(e, tuple):
            return None if not e else e[0] if len(e) == 1 else e
        return e
    return tuple(one(e) for e in entries)


def lm_rules(dp_axes, tp_axis: str, *, pure_dp: bool = False
             ) -> dict[str, tuple]:
    """The LM rule set (``policy.py:123-177``), as data: each rule a tuple
    of one entry per dimension, as ``tuple(PartitionSpec)`` gives it.

    dp_axes: mesh axes sharding the batch (e.g. ("data",) or ("pod",
    "data")); tp_axis: the tensor-parallel axis ("model"). pure_dp=True:
    every mesh axis shards the batch and the parameters are replicated.
    Default: TP/SP, Megatron-style (the reference's docstring).
    """
    dp = _axes_tuple(dp_axes)
    tp = tp_axis
    if pure_dp:
        batch = dp + (tp,)
        return {
            "act_btd": _spec(batch, None, None),
            "act_attn_in": _spec(batch, None, None),
            "act_bhsd": _spec(batch, None, None, None),
            "act_btf": _spec(batch, None, None),
            "logits": _spec(batch, None, None),
            "kv_cache": _spec(None, batch, None, None, None),
            "p_embed": (), "p_head": (), "p_norm": (),
            "p_attn_in": (), "p_attn_out": (),
            "p_mlp_in": (), "p_mlp_out": (),
            "p_router": (), "p_expert_in": (), "p_expert_out": (),
        }
    return {
        "act_btd": _spec(dp, tp, None),
        "act_attn_in": _spec(dp, None, None),
        "act_bhsd": _spec(dp, tp, None, None),
        "act_btf": _spec(dp, None, tp),
        "logits": _spec(dp, None, tp),
        "kv_cache": _spec(None, dp, None, None, None),
        "p_embed": _spec(tp, None),
        "p_head": _spec(None, tp),
        "p_norm": (),
        "p_attn_in": _spec(None, None, tp),
        "p_attn_out": _spec(None, tp, None),
        "p_mlp_in": _spec(None, None, tp),
        "p_mlp_out": _spec(None, tp, None),
        "p_router": (),
        "p_expert_in": _spec(None, tp, None, None),
        "p_expert_out": _spec(None, tp, None, None),
    }

"""ShardingPolicy: the one object that carries "how is this run sharded"
(port of ``src/repro/dist/policy.py``).

The policy is a ``torch.distributed`` ``DeviceMesh`` (or None) and a dict
of named layout rules. Each rule is a tuple with one entry per dimension,
as ``tuple(PartitionSpec)`` gives it: None (replicated), an axis name, or
a tuple of two or more axis names (one axis is its bare name, none is
None); ``()`` is the fully replicated ``P()``.

  * single-device (``NO_SHARDING``): ``sharding`` is None and
    ``constrain`` the identity, as in the reference;
  * under a mesh the program is explicit SPMD: one process per rank, each
    holding its local shard of every tensor, and collectives on the
    mesh's groups where the reference's GSPMD would insert them. The
    RkMIPS engine shards its user rows and the forward scan its item rows
    over every mesh axis (``engine/sharding.py``), in the order
    ``shard_rank`` gives. The models (slice 16: ``models/transformer.py``,
    ``models/moe.py``, ``models/embedding.py``) keep each named tensor in
    its rule's layout: ``sharding(name)`` is the rule as placements over
    the ``DeviceMesh`` (one ``Shard(dim)`` or ``Replicate()`` a mesh
    dimension), and ``relayout(x, src, dst)`` moves a rank-local tensor
    from one layout to another (a gather, a scatter-reduce of partial
    sums, a slice): the explicit form of what GSPMD inserts between two
    ``constrain``s. ``constrain`` of a plain local tensor under a mesh
    raises, pointing to ``relayout``: a local tensor has no layout to
    pin, and a silent identity would hide a missing collective.

A dim sharded over several axes is tiled row-major over them in the
rule's order, as JAX tiles ``P(("data", "model"))``: rank (i, j) of a
(2, 2) mesh holds chunk ``i * 2 + j``.

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
    # each parameter's layout rule by name (``with_params``)
    params: Mapping[str, tuple] = dataclasses.field(default_factory=dict)

    # -- rule lookup -------------------------------------------------------

    def with_params(self, rules: Mapping[str, tuple]) -> "ShardingPolicy":
        """This policy carrying each parameter's layout rule by name
        (``transformer.param_rules(cfg, policy)``): what the train step's
        gradient reduction, the optimizers' statistics over whole leaves
        and the checkpoints of a sharded state read (``param_rule``)."""
        return dataclasses.replace(self, params=dict(rules))

    def param_rule(self, name: str) -> tuple:
        """The layout rule of parameter ``name`` (``with_params``)."""
        if name not in self.params:
            raise KeyError(f"the policy carries no rule for parameter "
                           f"{name!r}: make it with policy.with_params("
                           f"transformer.param_rules(cfg, policy))")
        return tuple(self.params[name])

    def spec(self, name: str) -> tuple | None:
        """The layout rule registered under ``name`` (None if absent)."""
        return self.rules.get(name)

    def axes(self, spec) -> tuple[tuple[str, ...], ...]:
        """``spec`` (a rule name or a rule) as one tuple of axis names per
        dimension; a name the policy has no rule for raises."""
        if isinstance(spec, str):
            if spec not in self.rules:
                raise KeyError(f"the policy has no rule {spec!r}")
            spec = self.rules[spec]
        return tuple(_axes_tuple(e) for e in spec)

    def sharding(self, name: str):
        """None when unsharded or the rule is unknown; under a mesh the
        rule as ``DeviceMesh`` placements, one a mesh dimension:
        ``Shard(d)`` where the mesh axis shards dim d, else
        ``Replicate()``."""
        if self.mesh is None or name not in self.rules:
            return None
        from torch.distributed.tensor import Replicate, Shard
        names = self._names()
        where = {}
        for d, axes in enumerate(self.axes(name)):
            order = [names.index(a) for a in axes if a in names]
            if order != sorted(order):
                raise ValueError(f"rule {name!r}: dim {d} is tiled over "
                                 f"{axes}, not in the mesh's order {names}; "
                                 f"placements cannot say so")
            for a in axes:
                if a in where:
                    raise ValueError(f"rule {name!r} shards two dims over "
                                     f"mesh axis {a!r}")
                where[a] = d
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in names)

    def constrain(self, x, name: str):
        """Pin ``x`` to the layout of rule ``name``: the identity without
        a mesh or for an unknown name, as in the reference. Under a mesh
        a rank's local tensor raises (use ``relayout``)."""
        if self.sharding(name) is None:
            return x
        raise TypeError(
            f"constrain({name!r}) of a local tensor under a mesh: the port "
            f"runs explicit SPMD, so a rank's tensor has no layout to pin; "
            f"move it with policy.relayout(x, src, {name!r})")

    def axis_index(self, axes) -> int:
        """This rank's chunk index along a dim tiled over ``axes`` (a name
        or a tuple, row-major in its order); 0 without a mesh."""
        if self.mesh is None:
            return 0
        idx = 0
        for a in _axes_tuple(axes):
            if a in self._names():
                idx = idx * self.axis_size(a) + int(
                    self.mesh.get_local_rank(a))
        return idx

    def axes_size(self, axes) -> int:
        """The product of the sizes of ``axes`` (1 without a mesh)."""
        size = 1
        for a in _axes_tuple(axes):
            size *= self.axis_size(a)
        return size

    def local_shape(self, shape, spec, what: str = "tensor") -> tuple:
        """The rank-local shape of a global ``shape`` in layout ``spec``;
        a dim its axes do not divide raises, naming ``what`` and the
        dim."""
        axes = self.axes(spec)
        if len(axes) > len(shape):
            raise ValueError(f"{what}: layout {axes} has more dims than "
                             f"shape {tuple(shape)}")
        out = list(shape)
        for d, a in enumerate(axes):
            n = self.axes_size(a)
            if out[d] % n:
                raise ValueError(f"{what}: dim {d} of shape {tuple(shape)} "
                                 f"({out[d]}) does not divide over {a} "
                                 f"({n} ranks)")
            out[d] //= n
        return tuple(out)

    def relayout(self, x: torch.Tensor, src, dst, *,
                 partial=()) -> torch.Tensor:
        """Move the rank-local ``x`` from layout ``src`` to layout ``dst``
        (each a rule name or a rule; trailing dims absent from a rule are
        replicated). ``partial`` names mesh axes over which the ranks'
        ``x`` are partial sums of the true value: each is reduced, by a
        reduce-scatter onto the dim ``dst`` newly shards over it, else by
        an all-reduce. Then each dim is gathered over the axes ``src``
        has and ``dst`` has not, and sliced over the axes ``dst`` adds;
        slicing alone needs no communication. The identity without a
        mesh. Differentiable: each collective has its conjugate backward
        and a slice's gradient is zero outside the rank's chunk
        (``dist/collectives.py``)."""
        if self.mesh is None:
            return x
        from repro_torch.dist import collectives as coll
        nd = x.dim()
        pad = lambda axes: axes + ((),) * (nd - len(axes))  # noqa: E731
        s_axes = list(pad(self.axes(src)))
        d_axes = pad(self.axes(dst))
        for a in _axes_tuple(partial):
            if self.axis_size(a) == 1:
                continue
            dims = [d for d in range(nd)
                    if d_axes[d][:len(s_axes[d]) + 1] == s_axes[d] + (a,)]
            if dims:
                x = coll.reduce_scatter(x, self, a, dims[0])
                s_axes[dims[0]] = s_axes[dims[0]] + (a,)
            else:
                x = coll.psum(x, self, a)
        for d in range(nd):
            have, want = s_axes[d], d_axes[d]
            keep = 0
            while (keep < min(len(have), len(want))
                   and have[keep] == want[keep]):
                keep += 1
            for a in reversed(have[keep:]):          # innermost first
                x = coll.all_gather(x, self, a, d)
            extra = want[keep:]
            if extra:
                n = self.axes_size(extra)
                if x.shape[d] % n:
                    raise ValueError(f"relayout: dim {d} of {tuple(x.shape)}"
                                     f" does not divide over {extra} ({n} "
                                     f"ranks)")
                x = x.chunk(n, dim=d)[self.axis_index(extra)]
        return x

    def sharded_over(self, spec) -> tuple[str, ...]:
        """The mesh axes of more than one rank that layout ``spec`` tiles
        some dim over, in mesh order: a tensor in ``spec`` is a different
        chunk on each rank along them."""
        used = {a for axes in self.axes(spec) for a in axes}
        return tuple(a for a in self._names()
                     if a in used and self.axis_size(a) > 1)

    def replicated_over(self, spec) -> tuple[str, ...]:
        """The mesh axes of more than one rank that layout ``spec`` tiles
        no dim over, in mesh order: a tensor in ``spec`` is the same on
        every rank along them (``()`` without a mesh)."""
        if self.mesh is None:
            return ()
        used = {a for axes in self.axes(spec) for a in axes}
        return tuple(a for a in self._names()
                     if a not in used and self.axis_size(a) > 1)

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

"""The collectives of the mesh paths, over the group that spans the mesh.

The reference's ``shard_map`` bodies end in ``all_gather(..., tiled=True)``
and ``psum`` over every mesh axis; under SPMD these are explicit
``torch.distributed`` calls on the policy's group (``ShardingPolicy.group``:
the default group unless a caller gave another over the same ranks, as
the serving runtime's compaction does, ``spare_group``), whose ranks the
mesh must span. Results come back in mesh order (``policy.shard_rank``),
the order JAX tiles ``P(axes)`` in, whatever the ranks' global numbers.

The caller initializes the process group and so picks the backend: NCCL
on a multi-GPU host, gloo on the CPU, and gloo over CUDA tensors where
several ranks share one card (NCCL refuses two ranks on one device).
Gloo takes CUDA tensors for every collective used here (list
``all_gather``, ``all_reduce``, ``broadcast``) and stages them through
the host itself, so no path here copies to the host on its own.
"""

from __future__ import annotations

import torch

from repro_torch.dist.policy import ShardingPolicy


def _dist():
    import torch.distributed as dist
    return dist


def check_mesh(policy: ShardingPolicy) -> None:
    """Raise unless ``policy.mesh`` is a ``DeviceMesh`` over the whole
    initialized world (the group every collective here runs on)."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = policy.mesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh policy needs a torch DeviceMesh, got "
                        f"{type(mesh).__name__}")
    world = _dist().get_world_size(policy.group)
    if mesh.size() != world:
        raise ValueError(f"the mesh holds {mesh.size()} ranks and the world "
                         f"{world}: a mesh must span the whole world")


def all_gather_cat(t: torch.Tensor, policy: ShardingPolicy,
                   dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) concatenated along ``dim``
    in mesh order: JAX's ``all_gather(t, axes, axis=dim, tiled=True)``."""
    dist = _dist()
    t = t.contiguous()
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(policy.group))]
    dist.all_gather(parts, t, group=policy.group)
    order = policy.mesh.mesh.flatten().tolist()
    return torch.cat([parts[r] for r in order], dim=dim)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise sum of every rank's ``t`` (JAX's ``psum``) over
    ``group`` (None: the default group), as a new tensor."""
    out = t.clone()
    _dist().all_reduce(out, group=group)
    return out


def check_same_call(queries: torch.Tensor, k: int, who: str,
                    group=None) -> None:
    """Hold the SPMD call contract: every rank calls ``who`` with the same
    queries and the same k. Ranks compare the shape and k first, then
    their queries with rank 0's, and all raise together on a mismatch
    (a rank that raised alone would leave the others waiting in the next
    collective). ``group`` spans the world (None: the default group)."""
    dist = _dist()
    dev = queries.device
    head = torch.tensor([queries.shape[0], queries.shape[-1], k],
                        dtype=torch.int64, device=dev)
    lo, hi = head.clone(), head.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise ValueError(f"{who}: the ranks disagree on (nq, d, k): from "
                         f"{lo.tolist()} to {hi.tolist()}; every rank must "
                         f"make the same call")
    first = queries.contiguous().clone()
    dist.broadcast(first, 0, group=group)
    same = torch.tensor([int(torch.equal(first, queries))],
                        dtype=torch.int64, device=dev)
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=group)
    if not int(same):
        raise ValueError(f"{who}: the ranks were given different queries; "
                         f"every rank must make the same call")


def group_timeout(group=None):
    """The timeout of ``group``'s backend (None: the default group), or
    None where the backend does not expose it."""
    dist = _dist()
    pg = group if group is not None else \
        dist.distributed_c10d._get_default_group()
    try:
        return pg._get_backend(torch.device(
            "cuda" if dist.get_backend(pg) == "nccl" else "cpu"
        )).options._timeout
    except Exception:  # noqa: BLE001 -- a backend without the option
        return None


def spare_group():
    """A new process group over every rank of the world, with the default
    group's timeout: collectives on it never interleave with those on the
    default group. Every rank must call it, in the same order (group
    creation is collective)."""
    return _dist().new_group(timeout=group_timeout())

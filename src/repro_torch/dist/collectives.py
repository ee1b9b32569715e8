"""The collectives of the mesh paths, over the group that spans the mesh or
over one mesh axis.

The reference's ``shard_map`` bodies end in ``all_gather(..., tiled=True)``
and ``psum`` over every mesh axis; under SPMD these are explicit
``torch.distributed`` calls on the policy's group (``ShardingPolicy.group``:
the default group unless a caller gave another over the same ranks, as
the serving runtime's compaction does, ``spare_group``), whose ranks the
mesh must span. Results come back in mesh order (``policy.shard_rank``),
the order JAX tiles ``P(axes)`` in, whatever the ranks' global numbers.

The model-parallel paths (slice 16: the LM's TP/SP layers, split-KV
decode, MoE expert parallelism, row-sharded tables) need collectives over
one named axis of the mesh, on ``mesh.get_group(axis)``: ``all_gather``
(JAX's ``all_gather(tiled=True)``), ``reduce_scatter`` (sum),
``all_to_all`` (JAX's ``split_axis``/``concat_axis``, ``tiled=True``),
and ``psum``/``pmax``/``pmean`` over a tuple of axes (one axis after the
other). A chunk's place is the rank's coordinate along the axis, not its
rank within the axis group.

Model-parallel training (slice 17) differentiates through them: each is a
``torch.autograd.Function`` whose backward is its conjugate collective,
under one convention for a tensor replicated along an axis (PORT.md,
"Model parallelism (training)"): a gathered tensor's gradient on a rank
is that rank's *partial* share (the ranks use the gathered tensor each
for their own work, and the shares sum to the true gradient), while a
``psum``'s replicated result carries the *full* gradient on every rank
(the ranks then compute the same thing, as the loss does). So
``all_gather`` <-> ``reduce_scatter`` on the same dim,
``all_to_all(split a, concat b)`` <-> ``all_to_all(split b, concat a)``,
``psum`` <-> the identity (``pmean``: the identity over the rank count),
and a slice of a replicated tensor (``ShardingPolicy.relayout``) <-> its
zero-padded gradient, which autograd's own slice gives. ``pmax`` carries
no gradient (the loss uses it as a constant shift). The backward runs its
collectives in the order autograd visits the nodes, the same on every
rank, since every rank builds the same graph.

Where the ranks go on to use a ``psum``'s result each for work of its own
(GAT's edge shards, ``models/gat.py``), its gradient arrives as the
ranks' partial shares: ``psum_fanout`` is that sum, its backward the
``psum`` of the shares.

Every collective of the data path adds the bytes of its output to the
kind's count while ``counting()`` is open (``all-gather``,
``all-reduce``, ``reduce-scatter``, ``all-to-all``): the reference's
output-shape proxy of its HLO (``src/repro/launch/roofline.py:61-69``),
which the mesh dry run records per device. On meta tensors (the dry run
over a fake process group, which moves no values) the call checks
(``check_same_call``, ``agree``) decide nothing and return.

The caller initializes the process group and so picks the backend: NCCL
on a multi-GPU host, gloo on the CPU, and gloo over CUDA tensors where
several ranks share one card (NCCL refuses two ranks on one device).
Gloo takes CUDA tensors for every collective used here and stages them
through the host itself, so no path here copies to the host on its own:
list ``all_gather``, ``all_reduce`` (sum and max), ``broadcast``,
``reduce_scatter`` and ``all_to_all_single``. It refuses the list
``all_to_all`` on CUDA tensors ("Backend gloo does not support
alltoall", seen on torch 2.11 with CUDA 12.8), so ``all_to_all`` is
written on ``all_to_all_single``, which NCCL takes as well.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.dist.policy import ShardingPolicy

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
_COUNTS: list[dict] = []          # the open ``counting()`` records


def _dist():
    import torch.distributed as dist
    return dist


@contextlib.contextmanager
def counting():
    """Count the output bytes of every data-path collective run inside,
    by kind (module docstring): ``with counting() as c: ...`` leaves
    ``c`` = {kind: bytes} for the kinds of ``KINDS``."""
    rec = {k: 0 for k in KINDS}
    _COUNTS.append(rec)
    try:
        yield rec
    finally:
        _COUNTS.remove(rec)


def _count(kind: str, out: torch.Tensor) -> None:
    for rec in _COUNTS:
        rec[kind] += out.numel() * out.element_size()


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
    out = torch.cat([parts[r] for r in order], dim=dim)
    _count("all-gather", out)
    return out


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise sum of every rank's ``t`` (JAX's ``psum``) over
    ``group`` (None: the default group), as a new tensor."""
    out = t.clone()
    _dist().all_reduce(out, group=group)
    _count("all-reduce", out)
    return out


def check_same_call(queries: torch.Tensor, k: int, who: str,
                    group=None) -> None:
    """Hold the SPMD call contract: every rank calls ``who`` with the same
    queries and the same k. Ranks compare the shape and k first, then
    their queries with rank 0's, and all raise together on a mismatch
    (a rank that raised alone would leave the others waiting in the next
    collective). ``group`` spans the world (None: the default group).
    Meta queries hold no values: nothing to compare."""
    if queries.is_meta:
        return
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


def agree(policy: ShardingPolicy, who: str, error: Exception | None,
          tokens: torch.Tensor, batch_axes=(), step: int = 0) -> None:
    """The model-parallel entry points' call contract, held before their
    first collective: every rank passed its own checks (``error`` is what
    they raised, or None), every rank is at the same ``step`` (a decode
    position), and ranks at the same coordinate along ``batch_axes`` hold
    the same ``tokens``. One all_gather of five int64 a call (a failure
    flag, the tokens' shape, a checksum of them, ``step``); on a
    mismatch every rank raises together, a rank that failed its own
    ``error``, the others a ``ValueError`` naming the ranks at fault (a
    rank that raised alone would leave the others waiting in the next
    collective). Meta tokens hold no values: only ``error`` decides."""
    import numpy as np
    if tokens.is_meta:
        if error is not None:
            raise error
        return
    t = tokens.reshape(tokens.shape[0], -1).to(torch.int64)
    weights = torch.arange(1, t.numel() + 1, dtype=torch.int64,
                           device=t.device).reshape(t.shape)
    mine = torch.tensor([int(error is not None), *t.shape, 0, step],
                        dtype=torch.int64, device=t.device)
    mine[3] = (t * weights).sum()
    rows = all_gather_cat(mine[None], policy).cpu()      # (world, 5)
    failed = rows[:, 0].nonzero().flatten().tolist()
    if failed:
        if error is not None:
            raise error
        raise ValueError(f"{who}: the ranks at mesh positions {failed} "
                         f"refused the call")
    if not bool((rows[:, 4] == rows[0, 4]).all()):
        raise ValueError(f"{who}: the ranks are at steps "
                         f"{rows[:, 4].tolist()}; every rank must make the "
                         f"same call")
    names = tuple(policy.mesh.mesh_dim_names)
    coords = np.stack(np.unravel_index(np.arange(rows.shape[0]),
                                       tuple(policy.mesh.mesh.shape)), 1)
    keys = [tuple(c[names.index(a)] for a in _axes(batch_axes))
            for c in coords]
    first = {}
    for i, key in enumerate(keys):
        j = first.setdefault(key, i)
        if not torch.equal(rows[i, 1:4], rows[j, 1:4]):
            raise ValueError(
                f"{who}: the ranks at mesh positions {j} and {i} hold the "
                f"same batch shard but were given different tokens; ranks "
                f"along the axes that do not split the batch must make the "
                f"same call")


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


# -- collectives over one mesh axis (model parallelism) ---------------------


def _axes(axes) -> tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_ranks(policy: ShardingPolicy, axis: str) -> list[int]:
    """The global ranks of this rank's line along mesh axis ``axis``, in
    coordinate order (the order JAX tiles a dim sharded over ``axis``)."""
    dist = _dist()
    names = tuple(policy.mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no {axis!r}")
    mesh = policy.mesh.mesh
    dim = names.index(axis)
    coord = [int(c[0]) for c in (mesh == dist.get_rank()).nonzero(
        as_tuple=True)]
    coord[dim] = slice(None)
    return mesh[tuple(coord)].tolist()


def _axis_group(policy: ShardingPolicy, axis: str):
    """(the axis's process group, its group ranks in coordinate order)."""
    dist = _dist()
    group = policy.mesh.get_group(axis)
    return group, [dist.get_group_rank(group, r)
                   for r in _axis_ranks(policy, axis)]


def _all_gather(t: torch.Tensor, policy: ShardingPolicy, axis: str,
                dim: int) -> torch.Tensor:
    dist = _dist()
    group, order = _axis_group(policy, axis)
    if len(order) == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in order]
    dist.all_gather(parts, t, group=group)
    out = torch.cat([parts[g] for g in order], dim=dim)
    _count("all-gather", out)
    return out


def _reduce_scatter(t: torch.Tensor, policy: ShardingPolicy, axis: str,
                    dim: int) -> torch.Tensor:
    dist = _dist()
    group, order = _axis_group(policy, axis)
    n = len(order)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter over {axis!r} ({n} ranks): dim "
                         f"{dim} of shape {tuple(t.shape)} does not divide")
    chunks = [c.contiguous() for c in t.chunk(n, dim=dim)]
    send = [None] * n
    for c, g in enumerate(order):
        send[g] = chunks[c]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, send, group=group)
    _count("reduce-scatter", out)
    return out


def _all_to_all(t: torch.Tensor, policy: ShardingPolicy, axis: str,
                split_axis: int, concat_axis: int) -> torch.Tensor:
    dist = _dist()
    group, order = _axis_group(policy, axis)
    n = len(order)
    if n == 1:
        return t
    if t.shape[split_axis] % n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks): split "
                         f"axis {split_axis} of shape {tuple(t.shape)} "
                         f"does not divide")
    moved = t.movedim(split_axis, 0)
    chunks = moved.reshape(n, moved.shape[0] // n, *moved.shape[1:])
    by_group = [None] * n
    for c, g in enumerate(order):
        by_group[g] = c
    send = chunks[by_group].contiguous()        # row g goes to group rank g
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    _count("all-to-all", recv)
    parts = [recv[g].movedim(0, split_axis) for g in order]
    return torch.cat(parts, dim=concat_axis)


def _reduce(t: torch.Tensor, policy: ShardingPolicy, axes, op):
    dist = _dist()
    out = t.clone(memory_format=torch.contiguous_format)
    for axis in _axes(axes):
        group, order = _axis_group(policy, axis)
        if len(order) > 1:
            dist.all_reduce(out, op=op, group=group)
            _count("all-reduce", out)
    return out


class _PsumFanout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, policy, axes):
        ctx.args = (policy, axes)
        return _reduce(t, policy, axes, _dist().ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad, *ctx.args, _dist().ReduceOp.SUM), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, policy, axis, dim):
        ctx.args = (policy, axis, dim)
        return _all_gather(t, policy, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter(grad, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, policy, axis, dim):
        ctx.args = (policy, axis, dim)
        return _reduce_scatter(t, policy, axis, dim)

    @staticmethod
    def backward(ctx, grad):
        return _all_gather(grad, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, policy, axis, split_axis, concat_axis):
        ctx.args = (policy, axis, split_axis, concat_axis)
        return _all_to_all(t, policy, axis, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        policy, axis, split_axis, concat_axis = ctx.args
        return (_all_to_all(grad, policy, axis, concat_axis, split_axis),
                None, None, None, None)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, policy, axes):
        return _reduce(t, policy, axes, _dist().ReduceOp.SUM)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def all_gather(t: torch.Tensor, policy: ShardingPolicy, axis: str,
               dim: int) -> torch.Tensor:
    """The shards of ``t`` along mesh axis ``axis`` concatenated along
    ``dim`` in coordinate order: JAX's ``all_gather(t, axis, axis=dim,
    tiled=True)``. Backward: ``reduce_scatter`` of the ranks' partial
    gradients (module docstring)."""
    return _AllGather.apply(t, policy, axis, dim)


def reduce_scatter(t: torch.Tensor, policy: ShardingPolicy, axis: str,
                   dim: int) -> torch.Tensor:
    """The sum of every rank's ``t`` along mesh axis ``axis``, of which
    this rank keeps its coordinate's chunk of ``dim``: JAX's
    ``psum_scatter(t, axis, scatter_dimension=dim, tiled=True)``.
    Backward: ``all_gather``."""
    return _ReduceScatter.apply(t, policy, axis, dim)


def all_to_all(t: torch.Tensor, policy: ShardingPolicy, axis: str, *,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """JAX's ``all_to_all(t, axis, split_axis, concat_axis, tiled=True)``:
    ``t`` cut into as many chunks along ``split_axis`` as the axis has
    ranks, chunk c sent to coordinate c, and the chunks received from
    coordinates 0, 1, ... concatenated along ``concat_axis``. One
    ``all_to_all_single`` (module docstring). Backward: the
    ``all_to_all`` with the two axes swapped."""
    return _AllToAll.apply(t, policy, axis, split_axis, concat_axis)


def psum(t: torch.Tensor, policy: ShardingPolicy, axes) -> torch.Tensor:
    """The sum of ``t`` over the mesh axes ``axes`` (a name or a tuple),
    as a new tensor: JAX's ``psum``. Backward: the identity (the
    replicated sum carries the full gradient on every rank)."""
    return _Psum.apply(t, policy, axes)


def psum_fanout(t: torch.Tensor, policy: ShardingPolicy,
                axes) -> torch.Tensor:
    """``psum`` for a sum the ranks then use each for work of its own
    (module docstring): the same value, and the backward the ``psum`` of
    the ranks' partial gradients, so that each rank's summand gets the
    whole gradient of the sum. (Megatron's pair: an all-reduce forward
    and an all-reduce backward.)"""
    return _PsumFanout.apply(t, policy, axes)


def pmax(t: torch.Tensor, policy: ShardingPolicy, axes) -> torch.Tensor:
    """The elementwise max of ``t`` over the mesh axes ``axes``; no
    gradient flows through it."""
    return _reduce(t.detach(), policy, axes, _dist().ReduceOp.MAX)


def pmean(t: torch.Tensor, policy: ShardingPolicy, axes) -> torch.Tensor:
    """The mean of ``t`` over the mesh axes ``axes``: JAX's ``pmean``."""
    n = 1
    for axis in _axes(axes):
        n *= policy.axis_size(axis)
    return psum(t, policy, axes) / n


def gather_to_first(t: torch.Tensor, policy: ShardingPolicy,
                    rule) -> torch.Tensor | None:
    """The whole tensor of the rank-local ``t`` in layout ``rule``, on the
    host of the mesh's first rank (``shard_rank`` 0, the rank that writes
    checkpoints); None on every other rank. One rank of each distinct
    chunk (the one at coordinate 0 along every axis the rule leaves
    replicated) sends it point to point, so the first rank receives each
    element once and no other rank holds more than its own shard. Every
    rank calls it, in the same order. Over gloo the chunks travel from
    the host (gloo's send and recv take CPU tensors); over NCCL from the
    device."""
    import itertools
    dist = _dist()
    names = tuple(policy.mesh.mesh_dim_names or ())
    grid = policy.mesh.mesh                   # global ranks by coordinate
    axes = policy.axes(tuple(rule) + (None,) * (t.dim() - len(rule)))
    used = {a for dim_axes in axes for a in dim_axes}
    me, first = dist.get_rank(), int(grid.reshape(-1)[0])
    host = "nccl" not in str(dist.get_backend(policy.group))
    local = t.detach().contiguous()
    if host:
        local = local.cpu()
    holders = [(int(grid[c]), dict(zip(names, c)))
               for c in itertools.product(*map(range, grid.shape))
               if not any(i and names[d] not in used
                          for d, i in enumerate(c))]
    if me != first:
        if any(r == me for r, _ in holders):
            dist.send(local, first, group=policy.group)
        return None
    whole = local.new_empty(tuple(n * policy.axes_size(a)
                                  for n, a in zip(local.shape, axes)))
    for r, coord in holders:
        part = local
        if r != me:
            part = torch.empty_like(local)
            dist.recv(part, r, group=policy.group)
        at = []
        for n, dim_axes in zip(local.shape, axes):
            c = 0
            for a in dim_axes:
                c = c * policy.axis_size(a) + coord.get(a, 0)
            at.append(slice(c * n, (c + 1) * n))
        whole[tuple(at)] = part
    return whole.cpu()

"""Graph Attention Network (GAT, Velickovic et al. 2018) by scatter ops.

Twin of ``src/repro/models/gat.py:35-181`` for one device. Message passing
is written from first principles, as in the reference:
  * SDDMM (edge scores):  e_ij = LeakyReLU(a_src . h_i + a_dst . h_j)
  * edge softmax:         a max over each node's incoming edges (for
                          stability only: no gradient flows through it)
                          and a sum over them
  * SpMM (aggregate):     the sum of alpha_ij * h_i over dst
The reference's ``segment_max`` over ``dst`` becomes ``scatter_reduce``
with ``"amax"`` from a -inf start (``segment_max``'s identity), its
``segment_sum`` becomes ``index_add``.

Graphs are edge lists (src, dst) with a validity mask so shapes stay
static: a padded edge points at node 0, scores -1e30 and weighs 0, so it
adds nothing to node 0's sums. A node with no incoming edge at all keeps
the -inf max, which nothing reads, and aggregates 0 / max(0, 1e-9) = 0,
as in the reference. Batched small graphs (the ``molecule`` shape) are
block-diagonal in the same representation.

The model is a ``GATModel`` holding one ``GATLayer`` a layer, with ``w``
(d_in, heads, d_out), ``a_src`` and ``a_dst`` (heads, d_out) named as the
reference's pytree, so ``models/convert.py`` copies its arrays as they
are.

Under a mesh policy (``gat.py:82-145``; explicit SPMD, one process a
rank) the graph's ``src``, ``dst`` and ``edge_mask`` are the rank's shard
of the edges, tiled over every mesh axis in mesh order; the node
features, the labels and the parameters are whole on every rank. Each
layer projects every node (the same work on each rank), then by
``cfg.agg_mode``:

* ``"allreduce"``: each rank scores its edges; the segment max is the
  ``pmax`` of the ranks' (no gradient, as on one device), and the sums
  ``num`` and ``den`` are ``psum_fanout``'d over every axis;
* ``"dst_partitioned"``: every edge of a rank's shard points at a node
  the rank owns, rank r owning nodes ``[r * N/P, (r + 1) * N/P)``; each
  rank reduces into its own nodes (``rel = clamp(dst - r * N/P)``, as
  the reference does) and the owned rows are all-gathered. The edges
  must arrive so partitioned: the reference clamps an edge on the wrong
  shard silently, and so does the port (a wrong answer, not an error).

Gradients follow the port's convention (``dist/collectives.py``): a
rank's parameter gradient is its share, the trainer sums the shares over
every axis. The loss hands each rank the gradient of its own nodes'
(or graphs') terms only and ``psum``s the total, so every replicated
tensor downstream carries a share; ``psum_fanout`` turns the shares of a
sum back into the whole gradient of each summand, and the dst-partitioned
gather's backward (a reduce-scatter) sums them onto the owner's rows.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.dist.policy import NO_SHARDING, ShardingPolicy
from repro_torch.engine.artifact import device_of

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    negative_slope: float = 0.2
    dtype: torch.dtype = torch.float32
    agg_mode: str = "allreduce"   # the mesh aggregation ("allreduce" |
    #                               "dst_partitioned"); one device
    #                               aggregates locally either way


def _layer_dims(cfg: GATConfig) -> list[tuple[int, int, int]]:
    """(d_in, heads, d_out) of each layer: heads concatenated between
    layers, one head of n_classes at the last."""
    dims, d_in = [], cfg.d_in
    for li in range(cfg.n_layers):
        last = li == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        dims.append((d_in, heads, d_out))
        d_in = d_out if last else heads * d_out
    return dims


class GATLayer(nn.Module):
    def __init__(self, d_in: int, heads: int, d_out: int, dtype, device):
        super().__init__()
        p = lambda *shape: nn.Parameter(  # noqa: E731
            torch.empty(shape, dtype=dtype, device=device))
        self.w = p(d_in, heads, d_out)
        self.a_src, self.a_dst = p(heads, d_out), p(heads, d_out)


class GATModel(nn.Module):
    def __init__(self, cfg: GATConfig, device=None):
        super().__init__()
        dev = device_of(device, "GATModel")
        self.cfg = cfg
        self.layers = nn.ModuleList(GATLayer(*dims, cfg.dtype, dev)
                                    for dims in _layer_dims(cfg))


@torch.no_grad()
def init_params(cfg: GATConfig, generator: torch.Generator,
                device="cuda") -> GATModel:
    """A ``GATModel`` on ``device`` with weights at the reference's scales
    (``w`` N(0, 1/d_in), ``a_src``/``a_dst`` N(0, 1/d_out)), drawn in
    float32 on the generator's device, layer by layer in the order w,
    a_src, a_dst. Torch's draws: parity tests convert the reference's
    arrays instead."""
    model = GATModel(cfg, device)
    for layer in model.layers:
        d_in, _, d_out = layer.w.shape
        for param, scale in ((layer.w, d_in ** -0.5),
                             (layer.a_src, d_out ** -0.5),
                             (layer.a_dst, d_out ** -0.5)):
            x = torch.randn(param.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            param.copy_((x * scale).to(cfg.dtype))
    return model


def _aggregate(h, src, dst, emask, p, cfg: GATConfig, n_seg: int, seg,
               reduce_max):
    """The edge softmax and the weighted sum of one edge set into
    ``n_seg`` segments by ``seg`` (E,) -> (num (n_seg, H, D), den
    (n_seg, H)); ``reduce_max`` combines the segment maxima (the mesh's
    ``pmax``, or the identity)."""
    s_src = torch.einsum("nhd,hd->nh", h, p.a_src)
    s_dst = torch.einsum("nhd,hd->nh", h, p.a_dst)
    e = torch.nn.functional.leaky_relu(s_src[src] + s_dst[dst],
                                       cfg.negative_slope)   # (E, H)
    e = torch.where(emask[:, None], e, _NEG)
    # the max only keeps exp() in range: its gradient would cancel
    # exactly, so none flows through it (the reference's stop_gradient)
    with torch.no_grad():
        gmax = reduce_max(torch.full(
            (n_seg, e.shape[1]), -torch.inf, dtype=e.dtype,
            device=e.device).scatter_reduce(
            0, seg[:, None].expand_as(e), e, "amax"))        # (n_seg, H)
    w = torch.exp(e - gmax[seg]) * emask[:, None]            # (E, H)
    den = torch.zeros((n_seg, e.shape[1]), dtype=w.dtype,
                      device=w.device).index_add(0, seg, w)  # (n_seg, H)
    num = torch.zeros((n_seg,) + h.shape[1:], dtype=h.dtype,
                      device=h.device).index_add(
        0, seg, w[:, :, None] * h[src])                      # (n_seg, H, D)
    return num, den


def gat_layer(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              emask: torch.Tensor, p: GATLayer, cfg: GATConfig,
              policy: ShardingPolicy = NO_SHARDING, *,
              last: bool) -> torch.Tensor:
    """x (N, d_in) -> (N, H*D), or (N, n_classes) for the last layer.
    ``src``/``dst`` are int64 (E,), ``emask`` bool (E,): the rank's edge
    shard under a mesh ``policy`` (module docstring)."""
    n = x.shape[0]
    h = torch.einsum("ni,ihd->nhd", x, p.w)                  # (N, H, D)
    if policy.mesh is None:
        num, den = _aggregate(h, src, dst, emask, p, cfg, n, dst,
                              lambda m: m)
        out = num / torch.clamp(den, min=1e-9)[:, :, None]
    else:
        from repro_torch.dist import collectives as coll
        axes = tuple(policy.mesh.mesh_dim_names)
        if cfg.agg_mode == "dst_partitioned":
            n_dev = policy.device_count
            if n % n_dev:
                raise ValueError(f"dst_partitioned: {n} nodes do not divide "
                                 f"over {n_dev} ranks: pad the node count")
            n_local = n // n_dev
            rel = torch.clamp(dst - policy.axis_index(axes) * n_local, 0,
                              n_local - 1)
            num, den = _aggregate(h, src, dst, emask, p, cfg, n_local, rel,
                                  lambda m: m)
            out = policy.relayout(
                num / torch.clamp(den, min=1e-9)[:, :, None],
                (axes, None, None), ())                      # (N, H, D)
        elif cfg.agg_mode == "allreduce":
            num, den = _aggregate(h, src, dst, emask, p, cfg, n, dst,
                                  lambda m: coll.pmax(m, policy, axes))
            num = coll.psum_fanout(num, policy, axes)
            den = coll.psum_fanout(den, policy, axes)
            out = num / torch.clamp(den, min=1e-9)[:, :, None]
        else:
            raise ValueError(f"unknown agg_mode {cfg.agg_mode!r}")
    if last:
        return out.mean(dim=1)                   # average heads
    return torch.nn.functional.elu(out.reshape(n, -1))   # concat heads


def forward(model: GATModel, graph: dict, cfg: GATConfig,
            policy: ShardingPolicy | None = None) -> torch.Tensor:
    """graph = {x (N, F), src (E,), dst (E,), edge_mask (E,)} -> logits
    (N, C); under a mesh ``policy`` the edges are the rank's shard and
    the logits whole on every rank."""
    policy = _policy(policy)
    src, dst = graph["src"].long(), graph["dst"].long()
    x = graph["x"]
    for li, p in enumerate(model.layers):
        x = gat_layer(x, src, dst, graph["edge_mask"], p, cfg, policy,
                      last=(li == cfg.n_layers - 1))
    return x


def _policy(policy) -> ShardingPolicy:
    if policy is None or policy.mesh is None:
        return NO_SHARDING
    from repro_torch.dist import collectives as coll
    coll.check_mesh(policy)
    return policy


def loss_fn(model: GATModel, graph: dict, cfg: GATConfig,
            policy=None) -> torch.Tensor:
    """Cross-entropy loss.

    Node-level: graph holds labels (N,) and label_mask (N,) bool.
    Graph-level (batched small graphs): graph also holds graph_id (N,)
    and graph_labels (n_graphs,); node logits are mean-pooled per graph
    before the softmax."""
    logits = forward(model, graph, cfg, policy)
    if "graph_id" in graph:
        gid = graph["graph_id"].long()
        n_graphs = graph["graph_labels"].shape[0]
        ones = torch.ones(logits.shape[0], dtype=torch.float32,
                          device=logits.device)
        counts = torch.zeros(n_graphs, dtype=torch.float32,
                             device=logits.device).index_add(0, gid, ones)
        pooled = torch.zeros((n_graphs, logits.shape[1]), dtype=logits.dtype,
                             device=logits.device).index_add(0, gid, logits)
        logits = pooled / torch.clamp(counts, min=1.0)[:, None]
        labels = graph["graph_labels"]
        w = torch.ones(n_graphs, dtype=torch.float32, device=logits.device)
    else:
        labels = graph["labels"]
        w = graph["label_mask"].to(torch.float32)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -logp.gather(1, labels.long()[:, None])[:, 0]
    policy = _policy(policy)
    if policy.mesh is None:
        return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)
    # each rank sums the terms of every P-th node (graph), P the ranks:
    # its backward is the gradient of its own terms, a share (module
    # docstring); the psum makes the loss the whole one on every rank
    from repro_torch.dist import collectives as coll
    axes = tuple(policy.mesh.mesh_dim_names)
    mine = (torch.arange(nll.shape[0], device=nll.device)
            % policy.device_count) == policy.axis_index(axes)
    total = coll.psum((nll * w * mine).sum(), policy, axes)
    return total / torch.clamp(w.sum(), min=1.0)

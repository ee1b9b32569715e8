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
are. The reference's edge sharding over a mesh (``agg_mode``) goes with
the cells half of the multi-GPU slice 17 of the port: a policy with a
mesh raises.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.dist.policy import CELLS_SLICE
from repro_torch.engine.artifact import device_of
from repro_torch.engine.sharding import check_policy

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
    agg_mode: str = "allreduce"   # the reference's mesh aggregation
    #                               ("allreduce" | "dst_partitioned"); one
    #                               device aggregates locally either way


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


def gat_layer(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              emask: torch.Tensor, p: GATLayer, cfg: GATConfig, *,
              last: bool) -> torch.Tensor:
    """x (N, d_in) -> (N, H*D), or (N, n_classes) for the last layer.
    ``src``/``dst`` are int64 (E,), ``emask`` bool (E,)."""
    n = x.shape[0]
    h = torch.einsum("ni,ihd->nhd", x, p.w)                  # (N, H, D)
    s_src = torch.einsum("nhd,hd->nh", h, p.a_src)
    s_dst = torch.einsum("nhd,hd->nh", h, p.a_dst)
    e = torch.nn.functional.leaky_relu(s_src[src] + s_dst[dst],
                                       cfg.negative_slope)   # (E, H)
    e = torch.where(emask[:, None], e, _NEG)
    # the max only keeps exp() in range: its gradient would cancel
    # exactly, so none flows through it (the reference's stop_gradient)
    with torch.no_grad():
        gmax = torch.full((n, e.shape[1]), -torch.inf, dtype=e.dtype,
                          device=e.device).scatter_reduce(
            0, dst[:, None].expand_as(e), e, "amax")         # (N, H)
    w = torch.exp(e - gmax[dst]) * emask[:, None]            # (E, H)
    den = torch.zeros((n, e.shape[1]), dtype=w.dtype,
                      device=w.device).index_add(0, dst, w)  # (N, H)
    num = torch.zeros(h.shape, dtype=h.dtype, device=h.device).index_add(
        0, dst, w[:, :, None] * h[src])                      # (N, H, D)
    out = num / torch.clamp(den, min=1e-9)[:, :, None]
    if last:
        return out.mean(dim=1)                   # average heads
    return torch.nn.functional.elu(out.reshape(n, -1))   # concat heads


def forward(model: GATModel, graph: dict, cfg: GATConfig,
            policy=None) -> torch.Tensor:
    """graph = {x (N, F), src (E,), dst (E,), edge_mask (E,)} -> logits
    (N, C)."""
    check_policy(policy, "gat forward", CELLS_SLICE)
    src, dst = graph["src"].long(), graph["dst"].long()
    x = graph["x"]
    for li, p in enumerate(model.layers):
        x = gat_layer(x, src, dst, graph["edge_mask"], p, cfg,
                      last=(li == cfg.n_layers - 1))
    return x


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
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)

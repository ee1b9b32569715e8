"""RecSys models: DeepFM, xDeepFM (CIN), DIN, and two-tower retrieval.

Twin of ``src/repro/models/recsys.py`` for one device. Each model is an
``nn.Module`` made on an explicit device, holding the
reference's pytree as parameters of the same names: a table, an MLP as a
list of ``Dense`` layers with ``w`` in the reference's (in, out) layout
and ``b``, and so on, so ``models/convert.py::recsys_params_from_jax``
copies the reference's arrays as they are. The functions keep the
reference's signatures, the model in place of the params pytree:

  DeepFM  (Guo et al. 2017):   logit = linear + FM2 + MLP(concat(emb))
          FM2 = 0.5 * sum_d[(sum_f v)^2 - sum_f v^2]
  xDeepFM (Lian et al. 2018):  CIN feature maps
          X^{k+1}_{h,d} = sum_{i,j} W^k_{h,i,j} X^k_{i,d} X^0_{j,d};
          logit = linear + w . concat_k(sum_d X^k) + MLP
  DIN     (Zhou et al. 2018):  target attention over the behaviour sequence
          a_t = MLP([h_t, e_q, h_t - e_q, h_t * e_q]); pooled = sum a_t h_t
  two-tower (Yi et al. RecSys'19): MLP towers -> dot; candidate scoring is
          MIPS, which is where the SAH sketch index plugs in
          (``launch/serve.py``).

The models run on the card unless the caller asks for the CPU
(``device="cpu"``): with no CUDA device the default raises. Making one on
the card turns TF32 off for matrix products and cuDNN, as the engine
does: a tower's output feeds SRP sign bits and an exact top-k.

The CIN contracts each layer as (b, H_k * F, D) outer products times the
(H, H_k * F) weight, over micro-chunks of the batch whose outer product
holds at most ``CIN_CHUNK_ELEMS`` elements, so no (B, H_k, F, D) tensor
larger than that is built at any batch (PORT.md, "Recsys"). When autograd
records, each micro-chunk runs under a checkpoint, so the backward too
holds one chunk's outer products at a time.

Under a mesh whose "model" axis has more than one rank the embedding
tables are row-sharded (``shard_tables``: the reference's ``P("model",
None)`` for each table, ``_recsys_param_specs``) and every lookup is
``models/embedding.py``'s masked local take summed over "model"; the rest
of a model is replicated. ``table_pad`` pads a table's rows to a multiple
of the "model" axis, as in the reference.

Parameters are trainable ``nn.Parameter``s and the losses (``ctr_loss``,
``din_loss``, ``twotower_loss``) record for autograd; a table's gradient
is dense, as the reference's ``jnp.take`` gives it. Under a mesh a
loss takes the rank's rows of the batch (split over the data axes, the
cells' ``act_btd``) and returns the global loss on every rank, as GSPMD
gives the reference: the CTR losses ``pmean`` the ranks' means over the
data axes, and the two-tower loss gathers every rank's item vectors and
``log_q`` over them, so each user row is scored against the whole
global batch. The ranks along "model" hold the same rows and do the same
work, which is why the trainer sums gradients over the batch axes only
(``train/trainer.py::reduce_grads``). The serving entry
points (``launch/serve.py``) run under ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.engine.artifact import device_of
from repro_torch.models import embedding as emb_lib

CIN_CHUNK_ELEMS = 1 << 26    # 256 MB of float32 outer products per chunk


@dataclasses.dataclass(frozen=True)
class CTRConfig:
    name: str
    embedding: emb_lib.EmbeddingConfig
    mlp_dims: tuple[int, ...]            # hidden dims; input/output added
    interaction: str                     # "fm" | "cin"
    cin_layers: tuple[int, ...] = ()
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str
    embedding: emb_lib.EmbeddingConfig   # field 0 = item vocab (hist+target)
    seq_len: int
    attn_mlp: tuple[int, ...]            # e.g. (80, 40)
    mlp_dims: tuple[int, ...]            # e.g. (200, 80)
    dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str
    user_embedding: emb_lib.EmbeddingConfig
    item_embedding: emb_lib.EmbeddingConfig
    tower_dims: tuple[int, ...] = (1024, 512, 256)
    out_dim: int = 256
    dtype: torch.dtype = torch.float32


# -- parameters ---------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class Dense(nn.Module):
    """One MLP layer: ``x @ w + b``, w (in, out) as the reference keeps it."""

    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device)


def _mlp(dims: tuple[int, ...], dtype, device) -> nn.ModuleList:
    return nn.ModuleList(Dense(dims[i], dims[i + 1], dtype, device)
                         for i in range(len(dims) - 1))


def _on_device(device, who: str) -> torch.device:
    dev = device_of(device, who)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class CTRModel(nn.Module):
    """DeepFM / xDeepFM: ``table`` (R, D), ``linear`` (total_rows,),
    ``mlp``, and for CIN ``cin`` (one (H_{k+1}, H_k, F) weight a layer)
    and ``cin_out`` (sum H_k,)."""

    def __init__(self, cfg: CTRConfig, device=None):
        super().__init__()
        dev = _on_device(device, "CTRModel")
        self.cfg = cfg
        e = cfg.embedding
        f, d = e.n_fields, e.dim
        self.table = _param((e.total_rows, d), e.dtype, dev)
        self.linear = _param((e.total_rows,), cfg.dtype, dev)
        self.mlp = _mlp((f * d,) + cfg.mlp_dims + (1,), cfg.dtype, dev)
        if cfg.interaction == "cin":
            sizes = (f,) + cfg.cin_layers
            self.cin = nn.ParameterList(
                _param((sizes[i + 1], sizes[i], f), cfg.dtype, dev)
                for i in range(len(cfg.cin_layers)))
            self.cin_out = _param((sum(cfg.cin_layers),), cfg.dtype, dev)


class DINModel(nn.Module):
    """DIN: ``table``, the attention MLP ``attn`` and the main ``mlp``."""

    def __init__(self, cfg: DINConfig, device=None):
        super().__init__()
        dev = _on_device(device, "DINModel")
        self.cfg = cfg
        e = cfg.embedding
        d, n_profile = e.dim, e.n_fields - 1
        self.table = _param((e.total_rows, d), e.dtype, dev)
        self.attn = _mlp((4 * d,) + cfg.attn_mlp + (1,), cfg.dtype, dev)
        self.mlp = _mlp(((2 + n_profile) * d,) + cfg.mlp_dims + (1,),
                        cfg.dtype, dev)


class TwoTowerModel(nn.Module):
    """Two-tower: ``user_table``, ``item_table``, ``user_mlp``,
    ``item_mlp``."""

    def __init__(self, cfg: TwoTowerConfig, device=None):
        super().__init__()
        dev = _on_device(device, "TwoTowerModel")
        self.cfg = cfg
        ue, ie = cfg.user_embedding, cfg.item_embedding
        self.user_table = _param((ue.total_rows, ue.dim), ue.dtype, dev)
        self.item_table = _param((ie.total_rows, ie.dim), ie.dtype, dev)
        tail = cfg.tower_dims + (cfg.out_dim,)
        self.user_mlp = _mlp((ue.n_fields * ue.dim,) + tail, cfg.dtype, dev)
        self.item_mlp = _mlp((ie.n_fields * ie.dim,) + tail, cfg.dtype, dev)


def model_for(cfg, device=None) -> nn.Module:
    """The (uninitialised) model of a recsys config."""
    for cls, kind in ((CTRModel, CTRConfig), (DINModel, DINConfig),
                      (TwoTowerModel, TwoTowerConfig)):
        if isinstance(cfg, kind):
            return cls(cfg, device)
    raise TypeError(f"not a recsys config: {type(cfg).__name__}")


# -- init (torch's draws at the reference's scales) --------------------------


def _normal(param: nn.Parameter, generator: torch.Generator,
            scale: float) -> None:
    x = torch.randn(param.shape, generator=generator,
                    device=generator.device, dtype=torch.float32)
    param.copy_(x.mul_(scale).to(param.dtype))


def _init_mlp(layers: nn.ModuleList, generator: torch.Generator) -> None:
    for layer in layers:
        _normal(layer.w, generator, layer.w.shape[0] ** -0.5)
        layer.b.zero_()


def _padded_table(model: nn.Module, name: str, generator, ecfg,
                  table_pad: int) -> None:
    """Draw table ``name`` with its rows padded to ``table_pad``."""
    table = emb_lib.init_table(generator, ecfg, pad_to=table_pad)
    setattr(model, name, nn.Parameter(table.to(getattr(model, name).device)))


@torch.no_grad()
def init_ctr_params(generator: torch.Generator, cfg: CTRConfig, *,
                    device=None, table_pad: int = 1) -> CTRModel:
    """A ``CTRModel`` on ``device`` with weights at the reference's scales
    (``recsys.py:init_ctr_params``), drawn in float32 on the generator's
    device in the order table, linear, mlp, cin, cin_out. ``table_pad``
    pads the table's rows to a multiple (the reference's, for its
    row-sharded tables: ``shard_tables``)."""
    model = CTRModel(cfg, device)
    _padded_table(model, "table", generator, cfg.embedding, table_pad)
    _normal(model.linear, generator, 0.01)
    _init_mlp(model.mlp, generator)
    if cfg.interaction == "cin":
        f = cfg.embedding.n_fields
        for w in model.cin:
            _normal(w, generator, (w.shape[1] * f) ** -0.5)
        _normal(model.cin_out, generator, 0.01)
    return model


@torch.no_grad()
def init_din_params(generator: torch.Generator, cfg: DINConfig, *,
                    device=None, table_pad: int = 1) -> DINModel:
    """A ``DINModel`` on ``device`` (table, attn, mlp, in that order;
    ``table_pad`` as for ``init_ctr_params``)."""
    model = DINModel(cfg, device)
    _padded_table(model, "table", generator, cfg.embedding, table_pad)
    _init_mlp(model.attn, generator)
    _init_mlp(model.mlp, generator)
    return model


@torch.no_grad()
def init_twotower_params(generator: torch.Generator, cfg: TwoTowerConfig,
                         *, device=None, table_pad: int = 1
                         ) -> TwoTowerModel:
    """A ``TwoTowerModel`` on ``device`` (user table, item table, user
    mlp, item mlp, in that order; ``table_pad`` as for
    ``init_ctr_params``)."""
    model = TwoTowerModel(cfg, device)
    _padded_table(model, "user_table", generator, cfg.user_embedding,
                  table_pad)
    _padded_table(model, "item_table", generator, cfg.item_embedding,
                  table_pad)
    _init_mlp(model.user_mlp, generator)
    _init_mlp(model.item_mlp, generator)
    return model


TABLES = {"CTRModel": ("table",), "DINModel": ("table",),
          "TwoTowerModel": ("user_table", "item_table")}


@torch.no_grad()
def shard_tables(model: nn.Module, policy) -> nn.Module:
    """``model`` with each embedding table (``TABLES``) cut to the rank's
    contiguous block of rows under ``policy``'s "model" axis, in place;
    the rest stays whole. Returns the model."""
    if policy is None or policy.mesh is None:
        return model
    for name in TABLES[type(model).__name__]:
        table = getattr(model, name)
        setattr(model, name, nn.Parameter(emb_lib.shard_rows(table.detach(),
                                                             policy)))
    return model


# -- forward ------------------------------------------------------------------


def _mlp_apply(layers: nn.ModuleList, x: torch.Tensor,
               final_act: bool = False) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer.w + layer.b
        if i < len(layers) - 1 or final_act:
            x = torch.relu(x)
    return x


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    z = logits.to(torch.float32)
    y = labels.to(torch.float32)
    return torch.mean(torch.clamp(z, min=0) - z * y
                      + torch.log1p(torch.exp(-z.abs())))


def _cin_rows(x0: torch.Tensor, weights) -> torch.Tensor:
    xk, pooled = x0, []
    for w in weights:
        h, hk, f = w.shape
        z = (xk[:, :, None, :] * x0[:, None, :, :]).reshape(
            x0.shape[0], hk * f, x0.shape[2])          # (b, H_k F, D)
        xk = torch.matmul(w.reshape(h, hk * f), z)     # (b, H, D)
        pooled.append(xk.sum(dim=-1))                  # (b, H)
    return torch.cat(pooled, dim=-1)


def _cin(x0: torch.Tensor, weights) -> torch.Tensor:
    """Compressed Interaction Network. x0 (B, F, D) -> (B, sum(H_k)), in
    micro-chunks of the batch (module docstring)."""
    b, f, d = x0.shape
    widest = max(w.shape[1] for w in weights)
    rows = max(1, CIN_CHUNK_ELEMS // (widest * f * d))
    run = _cin_rows
    if torch.is_grad_enabled():
        run = functools.partial(checkpoint, _cin_rows, use_reentrant=False,
                                preserve_rng_state=False)
    return torch.cat([run(x0[i:i + rows], weights)
                      for i in range(0, b, rows)])


def ctr_forward(model: CTRModel, batch: dict, cfg: CTRConfig,
                policy=None) -> torch.Tensor:
    """batch = {"sparse": (B, n_fields) int} -> logits (B,)."""
    rows = emb_lib.flatten_ids(batch["sparse"], cfg.embedding)   # (B, F)
    v = emb_lib.embedding_bag(model.table, rows, policy)         # (B, F, D)
    b, f, d = v.shape

    logit = model.linear[rows].sum(dim=-1)                       # (B,)
    if cfg.interaction == "fm":
        s = v.sum(dim=1)                                         # (B, D)
        logit = logit + 0.5 * (s * s - (v * v).sum(dim=1)).sum(dim=-1)
    elif cfg.interaction == "cin":
        logit = logit + _cin(v, model.cin) @ model.cin_out
    deep = _mlp_apply(model.mlp, v.reshape(b, f * d))[:, 0]
    return logit + deep


def _dp_axes(policy) -> tuple[str, ...]:
    """The data axes of more than one rank a mesh ``policy``'s batch is
    split over (none without a mesh)."""
    if policy is None or policy.mesh is None:
        return ()
    return tuple(a for a in policy.dp_axes() if policy.axis_size(a) > 1)


def _global_mean(loss: torch.Tensor, policy) -> torch.Tensor:
    """The mean of the ranks' equal-sized batch means over the data axes
    (the loss itself without a mesh)."""
    axes = _dp_axes(policy)
    if not axes:
        return loss
    from repro_torch.dist import collectives as coll
    return coll.pmean(loss, policy, axes)


def ctr_loss(model: CTRModel, batch: dict, cfg: CTRConfig,
             policy=None) -> torch.Tensor:
    return _global_mean(bce_loss(ctr_forward(model, batch, cfg, policy),
                                 batch["label"]), policy)


def din_forward(model: DINModel, batch: dict, cfg: DINConfig,
                policy=None) -> torch.Tensor:
    """batch = {"hist" (B,T), "hist_mask" (B,T), "target" (B,),
    "profile" (B, n_profile)} -> logits (B,)."""
    off = cfg.embedding.offsets
    h = emb_lib.embedding_bag(model.table, batch["hist"] + int(off[0]),
                              policy)                               # (B,T,D)
    e = emb_lib.embedding_bag(model.table, batch["target"] + int(off[0]),
                              policy)                               # (B,D)
    # profile fields use table fields 1..n (field 0 is the item vocab)
    prof_rows = batch["profile"] + torch.as_tensor(
        off[1:], dtype=batch["profile"].dtype, device=batch["profile"].device)
    prof = emb_lib.embedding_bag(model.table, prof_rows, policy)

    eq = e[:, None, :].expand_as(h)
    a_in = torch.cat([h, eq, h - eq, h * eq], dim=-1)               # (B,T,4D)
    scores = _mlp_apply(model.attn, a_in)[..., 0]                   # (B,T)
    scores = torch.where(batch["hist_mask"], scores, -1e30)
    # softmax in float32 at least (the reference's), float64 in float64
    soft = torch.promote_types(scores.dtype, torch.float32)
    w = torch.softmax(scores.to(soft), dim=-1).to(h.dtype)
    pooled = torch.einsum("bt,btd->bd", w, h)

    feats = torch.cat([pooled, e, prof.reshape(prof.shape[0], -1)], dim=-1)
    return _mlp_apply(model.mlp, feats)[:, 0]


def din_loss(model: DINModel, batch: dict, cfg: DINConfig,
             policy=None) -> torch.Tensor:
    return _global_mean(bce_loss(din_forward(model, batch, cfg, policy),
                                 batch["label"]), policy)


def user_tower(model: TwoTowerModel, user_feats: torch.Tensor,
               cfg: TwoTowerConfig, policy=None) -> torch.Tensor:
    rows = emb_lib.flatten_ids(user_feats, cfg.user_embedding)
    v = emb_lib.embedding_bag(model.user_table, rows, policy)
    return _mlp_apply(model.user_mlp, v.reshape(v.shape[0], -1))


def item_tower(model: TwoTowerModel, item_feats: torch.Tensor,
               cfg: TwoTowerConfig, policy=None) -> torch.Tensor:
    rows = emb_lib.flatten_ids(item_feats, cfg.item_embedding)
    v = emb_lib.embedding_bag(model.item_table, rows, policy)
    return _mlp_apply(model.item_mlp, v.reshape(v.shape[0], -1))


def twotower_loss(model: TwoTowerModel, batch: dict, cfg: TwoTowerConfig,
                  policy=None) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction.

    batch = {"user_feats" (B,Fu), "item_feats" (B,Fi), "log_q" (B,)}.
    Row i's positive is item i; all other rows are negatives. Under a
    mesh the rank's user rows against the items of the whole global batch
    (module docstring).
    """
    u = user_tower(model, batch["user_feats"], cfg, policy)
    v = item_tower(model, batch["item_feats"], cfg, policy)
    log_q = batch["log_q"]
    axes, first = _dp_axes(policy), 0
    if axes:
        rows = (axes,) + (None,) * (v.dim() - 1)
        first = policy.axis_index(axes) * v.shape[0]
        v = policy.relayout(v, rows, ())
        log_q = policy.relayout(log_q, (axes,), ())
    logits = (u @ v.T).to(torch.float32)                # (B, B)
    logits = logits - log_q[None, :]                    # logQ correction
    logp = torch.log_softmax(logits, dim=-1)
    own = torch.diagonal(logp, offset=first)
    return _global_mean(-torch.mean(own), policy)


def retrieval_scores(user_vec: torch.Tensor,
                     cand_vecs: torch.Tensor) -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) brute-force scores (the exact baseline;
    the SAH-indexed path lives in launch/serve.py)."""
    return user_vec @ cand_vecs.T

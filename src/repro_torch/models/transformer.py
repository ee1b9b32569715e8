"""Decoder-only LM transformer (dense: GQA, RoPE, qk-norm, QKV bias,
SwiGLU; and MoE) with train (``lm_loss``), prefill and decode entry points.

Twin of ``src/repro/models/transformer.py`` for one device. The reference
keeps its parameters as a pytree with a leading (L,) layer axis and runs
the stack as one ``lax.scan``; here the model is an ``LM`` module holding
one ``Block`` per layer, run by a Python loop. Weight matrices keep the
reference's (in, out) layout and are used as ``x @ w``, so
``models/convert.py`` copies the reference's arrays as they are.

``LMConfig`` drops ``scan_layers``, which chooses how JAX traces the
layer stack and means nothing to eager PyTorch.

Model parallelism (``policy=`` with a mesh; slice 16 of the port's
multi-GPU work) is explicit SPMD: every rank holds its shard of the model
(``init_params(..., policy=)`` draws it, ``shard_lm`` cuts it from a
whole ``LM``, both by ``param_specs``) and calls the entry points with
its local tensors in the policy's layouts: tokens (B_local, S) with the
batch over ``act_btd``'s batch axes, logits (B_local, V_local) in the
``logits`` layout, the cache in ``kv_cache``'s. Each reference
``constrain`` boundary becomes a ``relayout`` (``dist/policy.py``), the
identity without a mesh, so one code path runs both:

  * embed: vocab rows over "model": a masked local take, reduce-scattered
    onto the sequence-parallel residual (``act_btd``); the residual and
    the norms stay sequence-parallel;
  * ``act_attn_in``: the sequence gathered; q/k/v column-parallel
    (``p_attn_in``), reshaped into the rank's heads (``act_bhsd``; GQA's
    ratio kept, the flash kernel over the rank's heads), or gathered to
    every head where the heads are not sharded (``tp_heads=False``);
  * ``wo`` and ``w_out`` row-parallel: float32 partial sums
    reduce-scattered back onto ``act_btd`` (one rounding to the model
    dtype, as one device's matrix product has); ``act_btf`` column-
    parallel; an MoE layer runs expert parallelism on its
    sequence-parallel tokens (``models/moe.py``);
  * the head vocab-sharded: logits in the ``logits`` layout, and
    ``greedy`` reduces (max, lowest id) over the vocabulary's axes;
  * prefill's cache gathered to ``kv_cache`` (heads replicated);
    ``relayout_cache`` moves it to the decode rules' layout (a slice of
    the sequence for ``launch/cells.py::_lm_rules``'s decode sets);
  * ``decode_step`` under the decode rules: the residual replicated over
    "model", q/k/v gathered to every head, the new position written on
    the rank that owns it, attention over each rank's KV-sequence shard
    merged by log-sum-exp over the cache's sequence axes
    (``models/attention.py``).

Training under a mesh (slice 17) runs the same layers under autograd:
the collectives differentiate (``dist/collectives.py``), a layer under
``remat="full"`` re-runs its forward's collectives in the backward (every
rank recomputes the same layers in the same order; the call check runs
once, at the entry), and ``lm_loss`` takes the cross-entropy over the
vocabulary shards (its docstring). The parameters' gradients come out
per rank, each the rank's share: ``train/trainer.py`` sums them over the
axes a parameter is replicated along (PORT.md, "Model parallelism
(training)").

With ``moe`` set each layer's FFN is ``models/moe.py``'s and
``forward``'s aux is the mean of the layers' load-balance losses.
``remat="full"`` (the default, as in the reference) runs each layer under
``torch.utils.checkpoint`` when autograd records, so a layer keeps only
its input for the backward and recomputes the rest.

Parameters are trainable ``nn.Parameter``s; ``forward`` and ``lm_loss``
record for autograd, while the serving entry points ``prefill``,
``decode_step`` and ``full_logits`` run under ``torch.no_grad()``.

Numerics follow the reference step for step: ``_rms_norm`` in float32,
cast to the input's dtype, then times the scale; rotate-half RoPE with
float32 angles; residuals ``x + (o @ wo).to(x.dtype)``; the FFN
``(silu(h @ w_gate) * (h @ w_in)) @ w_out`` in the model dtype; logits in
float32. With ``attn_impl="flash"`` attention runs the hand-written CUDA
kernel on the card (``kernels/ops.flash_attention``); the default
``"chunked"`` is plain PyTorch (``models/attention.py``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.policy import NO_SHARDING
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import embedding as emb_lib
from repro_torch.models import moe as moe_lib

_ATTN_IMPLS = ("chunked", "flash")
_REMATS = ("full", "none")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    moe: moe_lib.MoEConfig | None = None
    dtype: torch.dtype = torch.bfloat16
    attn_chunk: int = 512
    attn_impl: str = "chunked"   # "chunked" (plain PyTorch) | "flash" (the
    #                              hand-written CUDA kernel on the card; the
    #                              O(S^2) plain version on the CPU; the
    #                              kernel has no backward and refuses grad)
    remat: str = "full"          # "full" (checkpoint each layer) | "none"
    max_seq: int = 4096          # decode cache length
    aux_loss_weight: float = 0.01

    def __post_init__(self):
        if self.moe is not None and not isinstance(self.moe,
                                                   moe_lib.MoEConfig):
            raise TypeError(f"{self.name}: moe must be a MoEConfig or None, "
                            f"got {type(self.moe).__name__}")
        if self.attn_impl not in _ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {_ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}")
        if self.remat not in _REMATS:
            raise ValueError(f"remat must be one of {_REMATS}, got "
                             f"{self.remat!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} is not a multiple of "
                             f"n_kv_heads {self.n_kv_heads}")

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else (
            self.d_model // self.n_heads)

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + head included), by the
        reference's arithmetic (biases and qk-norm scales not counted)."""
        d, hd = self.d_model, self.head_dim
        attn_p = d * self.n_heads * hd * 2 + d * self.n_kv_heads * hd * 2
        if self.moe is not None:
            ffn = (d * self.moe.n_experts
                   + 3 * self.moe.n_experts * d * self.moe.d_ff_expert)
        else:
            ffn = 3 * d * self.d_ff
        per_layer = attn_p + ffn + 2 * d
        return self.n_layers * per_layer + 2 * self.vocab * d + d

    @property
    def n_active_params(self) -> int:
        """Active parameters per token (MoE: the top_k experts only)."""
        if self.moe is None:
            return self.n_params
        d, m = self.d_model, self.moe
        dense = self.n_params - self.n_layers * (
            3 * m.n_experts * d * m.d_ff_expert)
        return dense + self.n_layers * 3 * m.top_k * d * m.d_ff_expert


def _empty(cfg: LMConfig, device, *shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device))


class Block(nn.Module):
    """One layer's parameters, named as the reference's layer pytree: the
    FFN is ``w_in``/``w_gate``/``w_out`` or, with ``cfg.moe``, the ``moe``
    submodule."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
        nh, nkv = cfg.n_heads, cfg.n_kv_heads
        p = lambda *shape: _empty(cfg, device, *shape)  # noqa: E731
        self.wq, self.wk = p(d, nh * hd), p(d, nkv * hd)
        self.wv = p(d, nkv * hd)
        self.wo = p(nh * hd, d)
        self.ln1, self.ln2 = p(d), p(d)
        if cfg.qkv_bias:
            self.bq, self.bk, self.bv = p(nh * hd), p(nkv * hd), p(nkv * hd)
        if cfg.qk_norm:
            self.q_norm, self.k_norm = p(hd), p(hd)
        if cfg.moe is not None:
            self.moe = moe_lib.MoE(d, cfg.moe, cfg.dtype, device)
        else:
            self.w_in, self.w_gate, self.w_out = p(d, f), p(d, f), p(f, d)


class LM(nn.Module):
    """The model: ``embed`` (V, D), ``head`` (D, V), ``final_norm`` (D,)
    and ``blocks``, one ``Block`` per layer."""

    def __init__(self, cfg: LMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _empty(cfg, device, cfg.vocab, cfg.d_model)
        self.head = _empty(cfg, device, cfg.d_model, cfg.vocab)
        self.final_norm = _empty(cfg, device, cfg.d_model)
        self.blocks = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))


def _draws(cfg: LMConfig):
    """(parameter name, scale) of every drawn parameter, in the order the
    generator draws them: each block's wq, wk, wv, wo, then w_in, w_gate,
    w_out or its experts (``models/moe.py::draws``), then embed and
    head."""
    d, f = cfg.d_model, cfg.d_ff
    nhd = cfg.n_heads * cfg.head_dim
    for i in range(cfg.n_layers):
        yield from ((f"blocks.{i}.wq", d ** -0.5), (f"blocks.{i}.wk",
                    d ** -0.5), (f"blocks.{i}.wv", d ** -0.5),
                    (f"blocks.{i}.wo", nhd ** -0.5))
        if cfg.moe is None:
            yield from ((f"blocks.{i}.w_in", d ** -0.5),
                        (f"blocks.{i}.w_gate", d ** -0.5),
                        (f"blocks.{i}.w_out", f ** -0.5))
        else:
            yield from ((f"blocks.{i}.moe.{name}", scale) for name, scale
                        in moe_lib.draws(d, cfg.moe.d_ff_expert))
    yield from (("embed", 1.0), ("head", d ** -0.5))


def _set_param(model: nn.Module, name: str, value: torch.Tensor) -> None:
    owner, _, leaf = name.rpartition(".")
    setattr(model.get_submodule(owner) if owner else model, leaf,
            nn.Parameter(value))


def init_params(cfg: LMConfig, generator: torch.Generator,
                device="cuda", policy=None) -> LM:
    """An ``LM`` on ``device`` with weights drawn at the reference's
    scales: each matrix N(0, 1) * fan_in^-0.5 (the embedding N(0, 1)),
    drawn in float32 on the generator's device and cast to ``cfg.dtype``;
    norm scales 1, biases 0; an MoE layer's router in float32. The draws
    are torch's, not JAX's: to hold the port against the reference,
    convert the reference's own arrays (``models/convert.py``).

    Under a mesh ``policy`` the rank's shard (``shard_lm``'s) of the model
    the same generator draws without one: each parameter is drawn whole,
    in the same order, and only the rank's slice is kept."""
    model = LM(cfg, "meta")
    specs = None
    if _meshed(policy):
        _local_shapes(cfg, policy)           # raises on an indivisible dim
        specs = param_rules(cfg, policy)

    def keep(name, value):
        if specs is not None:
            value = policy.relayout(value, (), specs[name]).clone()
        _set_param(model, name, value.to(device))

    with torch.no_grad():
        for name, scale in _draws(cfg):
            meta = model.get_parameter(name)
            x = torch.randn(meta.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            keep(name, (x * scale).to(meta.dtype))
        for name, meta in list(model.named_parameters()):
            if meta.is_meta:        # norm scales 1, biases 0: no draws
                leaf = name.rpartition(".")[2]
                fill = 0.0 if leaf in ("bq", "bk", "bv") else 1.0
                keep(name, torch.full(meta.shape, fill, dtype=meta.dtype))
    return model


def param_specs(cfg: LMConfig, policy) -> dict:
    """The layout of every parameter (``transformer.py:128-154``), as the
    reference's nest of rules: per-layer leaves under ``layers`` with the
    leading (L,) axis, an MoE layer's under ``layers/moe``."""
    r = policy.rules
    layer = {
        "wq": r["p_attn_in"], "wk": r["p_attn_in"], "wv": r["p_attn_in"],
        "wo": r["p_attn_out"], "ln1": r["p_norm"], "ln2": r["p_norm"],
    }
    if cfg.qkv_bias:
        layer.update({"bq": (None, None), "bk": (None, None),
                      "bv": (None, None)})
    if cfg.qk_norm:
        layer.update({"q_norm": r["p_norm"], "k_norm": r["p_norm"]})
    if cfg.moe is not None:
        layer["moe"] = {
            "router": r["p_router"],
            "w_in": r["p_expert_in"], "w_gate": r["p_expert_in"],
            "w_out": r["p_expert_out"],
        }
    else:
        layer.update({"w_in": r["p_mlp_in"], "w_gate": r["p_mlp_in"],
                      "w_out": r["p_mlp_out"]})
    return {"embed": r["p_embed"], "head": r["p_head"],
            "final_norm": (None,), "layers": layer}


def param_rules(cfg: LMConfig, policy) -> dict[str, tuple]:
    """``param_specs`` keyed by the ``LM``'s parameter names: a block's
    leaf takes its layer rule less the stacked (L,) axis. A training
    policy carries them (``policy.with_params(param_rules(cfg, policy))``)
    for the train step, the optimizers and the checkpoints under a
    mesh."""
    specs = param_specs(cfg, policy)
    out = {name: specs[name] for name in ("embed", "head", "final_norm")}
    for i in range(cfg.n_layers):
        for name, spec in specs["layers"].items():
            if isinstance(spec, dict):
                out.update({f"blocks.{i}.{name}.{leaf}": tuple(sub)[1:]
                            for leaf, sub in spec.items()})
            else:
                out[f"blocks.{i}.{name}"] = tuple(spec)[1:]
    return out


@functools.lru_cache(maxsize=16)
def _global_shapes(cfg: LMConfig) -> dict[str, tuple]:
    return {name: tuple(p.shape)
            for name, p in LM(cfg, "meta").named_parameters()}


def _local_shapes(cfg: LMConfig, policy) -> dict[str, tuple]:
    specs = param_rules(cfg, policy)
    return {name: policy.local_shape(shape, specs[name], name)
            for name, shape in _global_shapes(cfg).items()}


@torch.no_grad()
def shard_lm(model: LM, policy) -> LM:
    """This rank's shard of the whole ``model`` under ``policy``: each
    parameter sliced to its ``param_specs`` layout (slicing only, no
    communication), on the parameter's device. A dim that a rule's axes
    do not divide raises, naming the parameter and the dim."""
    cfg = model.cfg
    specs = param_rules(cfg, policy)
    _local_shapes(cfg, policy)               # raises on an indivisible dim
    shard = LM(cfg, "meta")
    for name, p in model.named_parameters():
        _set_param(shard, name,
                   policy.relayout(p.detach(), (), specs[name]).clone())
    return shard


def _meshed(policy) -> bool:
    return policy is not None and policy.mesh is not None


def _check_shard(model: LM, policy, who: str) -> None:
    """Raise unless ``model`` is ``policy``'s shard."""
    want = _local_shapes(model.cfg, policy)
    for name, p in model.named_parameters():
        if tuple(p.shape) != want[name]:
            raise ValueError(
                f"{who}: parameter {name} is {tuple(p.shape)}, its shard "
                f"under the policy {want[name]}: pass the rank's shard "
                f"(shard_lm, or init_params(..., policy=))")


def _entry(model: LM, tokens: torch.Tensor, policy, who: str, *,
           decode: bool = False, check=None, step: int = 0) -> "_Layout":
    """The call's ``_Layout`` after its checks: the heads' split, the
    rank's shard, and ``check(lay)``. Without a mesh a check
    raises at once. Under one every rank runs them before its first
    collective and all raise together (``collectives.agree``, which also
    holds every rank at the same ``step`` and the tokens the same along
    the axes that do not split the batch)."""
    if not _meshed(policy):
        lay = _Layout(model.cfg, policy, decode)
        if check is not None:
            check(lay)
        return lay
    from repro_torch.dist import collectives as coll
    coll.check_mesh(policy)
    lay, error = None, None
    try:
        lay = _Layout(model.cfg, policy, decode)
        _check_shard(model, policy, who)
        if check is not None:
            check(lay)
    except Exception as e:  # noqa: BLE001 -- raised on every rank below
        error = e
    coll.agree(policy, who, error, tokens, policy.axes("act_btd")[0], step)
    return lay


class _Layout:
    """The mesh axes each tensor of a layer is tiled over under
    ``policy``, from its rules (every entry () without a mesh, where each
    ``relayout`` is the identity). ``decode``: the decode step's layout
    (projections from the replicated residual, q/k/v in the cache's head
    layout)."""

    def __init__(self, cfg: LMConfig, policy, decode: bool = False):
        self.policy = policy if policy is not None else NO_SHARDING
        self.mesh = _meshed(policy)
        if not self.mesh:
            none = ((),) * 5
            self.btd = self.attn_in = self.ffn = self.kv = self.logits = \
                none
            self.heads = self.col_attn = self.row_attn = self.col_ffn = \
                self.row_ffn = self.vocab_in = self.vocab_out = ()
            return
        def ax(name):               # a rule's axes, one entry a dim
            axes = self.policy.axes(name)
            return axes + ((),) * (5 - len(axes))   # () replicates

        self.btd = ax("act_btd")
        self.attn_in = self.btd if decode else ax("act_attn_in")
        self.kv = ax("kv_cache")
        self.heads = self.kv[2] if decode else ax("act_bhsd")[1]
        self.col_attn, self.row_attn = ax("p_attn_in")[2], \
            ax("p_attn_out")[1]
        self.ffn = ax("act_btf")
        self.col_ffn, self.row_ffn = ax("p_mlp_in")[2], ax("p_mlp_out")[1]
        self.vocab_in, self.vocab_out = ax("p_embed")[0], ax("p_head")[1]
        self.logits = ax("logits")
        n = self.policy.axes_size(self.heads)
        if cfg.n_heads % n or cfg.n_kv_heads % n:
            raise ValueError(
                f"{cfg.name}: {cfg.n_heads} query and {cfg.n_kv_heads} KV "
                f"heads do not shard over {self.heads} ({n} ranks); give "
                f"the heads a replicated rule (tp_heads=False)")

    def relayout(self, x, src, dst, partial=()):
        return self.policy.relayout(x, src, dst, partial=partial)

    def to_heads(self, *ts):
        """Column-parallel projections (B, S, F_local) over ``col_attn``
        -> the same in ``heads``' layout. Where the two differ the
        features are gathered in one collective for all of ``ts`` (each
        rank's blocks side by side), then sliced to ``heads``."""
        if self.heads == self.col_attn:
            return ts
        n = self.policy.axes_size(self.col_attn)
        sizes = [t.shape[-1] for t in ts]
        both = torch.cat(ts, dim=-1)[None]
        both = self.relayout(both, (self.col_attn,), ((),))  # (n, B, S, F)
        out = []
        for part in both.split(sizes, dim=-1):
            whole = part.movedim(0, 2).reshape(*part.shape[1:3],
                                               n * part.shape[-1])
            out.append(self.relayout(whole, (self.attn_in[0],
                                             self.attn_in[1], ()),
                                     (self.attn_in[0], self.attn_in[1],
                                      self.heads)))
        return tuple(out)

    def row_parallel(self, a, w, a_layout, rows):
        """``a @ w`` for ``w`` row-parallel over ``rows``, back in the
        residual's layout: ``a``'s features moved to ``rows``, the float32
        partial sums reduced onto ``act_btd``. Without a split it is the
        model-dtype product, as on one device."""
        a = self.relayout(a, a_layout, (a_layout[0], a_layout[1], rows))
        out = (a_layout[0], a_layout[1], ())
        if self.policy.axes_size(rows) == 1:
            return self.relayout(a @ w, out, self.btd)
        return self.relayout(_mm_f32(a, w), out, self.btd, partial=rows)


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` with a float32 result. On the card bf16 operands stay on
    the tensor cores with a float32 output (``torch.mm``'s ``out_dtype``:
    no float32 copy of the weight, no float32 product); elsewhere, for
    float32 operands, and where autograd records (``out_dtype`` has no
    derivative), the operands are upcast (exact for bf16), which gives the
    same sums up to their order."""
    records = torch.is_grad_enabled() and (a.requires_grad or
                                           w.requires_grad)
    if a.is_cuda and not records and a.dtype == w.dtype and \
            a.dtype in (torch.bfloat16, torch.float16):
        out = torch.mm(a.reshape(-1, a.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], w.shape[-1])
    return a.to(torch.float32) @ w.to(torch.float32)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x (..., S, Dh), positions (S,) -> rotated (rotate-half form)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[:, None].to(torch.float32) * freqs[None, :]   # (S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _project_qkv(x: torch.Tensor, p: Block, cfg: LMConfig,
                 positions: torch.Tensor, lay: _Layout | None = None):
    """x (B, S, D) -> q (B,H,S,Dh), k/v (B,Hkv,S,Dh) with RoPE applied.
    Under a mesh (``lay``) the column-parallel products hold the rank's
    features, moved to ``lay.heads`` (the rank's heads, or every head)."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if lay is not None and lay.mesh:
        if cfg.qkv_bias:
            q, k, v = (t + lay.relayout(bias, (), (lay.col_attn,))
                       for t, bias in ((q, p.bq), (k, p.bk), (v, p.bv)))
        q, k, v = lay.to_heads(q, k, v)
    elif cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, -1, hd).transpose(1, 2)
    k = k.reshape(b, s, -1, hd).transpose(1, 2)
    v = v.reshape(b, s, -1, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = _rms_norm(q, p.q_norm)
        k = _rms_norm(k, p.k_norm)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(h: torch.Tensor, p: Block, cfg: LMConfig, lay: _Layout):
    """The block's FFN on h (B, S, D) in the residual's layout -> (out,
    aux): the dense SwiGLU with a None aux (``act_btf`` column-parallel,
    ``w_out`` row-parallel under a mesh), or the MoE FFN and its
    load-balance loss (expert parallelism under a mesh)."""
    if cfg.moe is not None:
        if lay.mesh:
            return p.moe(h, cfg.moe, policy=lay.policy)
        return p.moe(h, cfg.moe)
    ffn_in = (lay.ffn[0], lay.ffn[1], ())
    h = lay.relayout(h, lay.btd, ffn_in)
    col = (lay.ffn[0], lay.ffn[1], lay.col_ffn)
    gate = lay.relayout(h @ p.w_gate, col, lay.ffn)
    up = lay.relayout(h @ p.w_in, col, lay.ffn)
    act = torch.nn.functional.silu(gate) * up
    return lay.row_parallel(act, p.w_out, lay.ffn, lay.row_ffn), None


def _layer(x: torch.Tensor, p: Block, cfg: LMConfig,
           positions: torch.Tensor, lay: _Layout):
    """One transformer block. x (B, S, D) in ``act_btd`` -> (x', aux,
    (k, v)); aux is None in a dense block. k/v hold the rank's heads."""
    h = lay.relayout(_rms_norm(x, p.ln1), lay.btd, lay.attn_in)
    q, k, v = _project_qkv(h, p, cfg, positions, lay)
    if cfg.attn_impl == "flash":
        # the kernel reads KV head h // n_rep in place: no repeated copy
        o = kops.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    else:
        rep = q.shape[1] // k.shape[1]
        o = attn.chunked_attention(q, attn.repeat_kv(k, rep),
                                   attn.repeat_kv(v, rep),
                                   chunk=min(cfg.attn_chunk, h.shape[1]))
    b, s = h.shape[:2]
    o = o.transpose(1, 2).reshape(b, s, -1)
    x = x + lay.row_parallel(o, p.wo, (lay.attn_in[0], lay.attn_in[1],
                                       lay.heads), lay.row_attn).to(x.dtype)
    f, aux = _ffn(_rms_norm(x, p.ln2), p, cfg, lay)
    x = x + f.to(x.dtype)
    return x, aux, (k, v)


def _layer_out(x: torch.Tensor, p: Block, cfg: LMConfig,
               positions: torch.Tensor, lay: _Layout):
    return _layer(x, p, cfg, positions, lay)[:2]


def _embed(model: LM, tokens: torch.Tensor, lay: _Layout) -> torch.Tensor:
    """tokens (B, S) -> (B, S, D) in ``act_btd``: under a mesh a masked
    take of the rank's vocabulary rows, the partial sums reduced onto the
    residual's layout (a reduce-scatter of the sequence in prefill)."""
    if not lay.mesh:
        return emb_lib.gather_rows(model.embed, tokens.reshape(-1)).reshape(
            *tokens.shape, model.embed.shape[1])
    part = emb_lib.local_take(model.embed, tokens, lay.policy, lay.vocab_in)
    return lay.relayout(part, (lay.btd[0], (), ()), lay.btd,
                        partial=lay.vocab_in)


def _logits(model: LM, x: torch.Tensor, lay: _Layout) -> torch.Tensor:
    """x (B, D) -> float32 logits (B, V), in the ``logits`` layout under
    a mesh (the rank's vocabulary columns)."""
    out = (x @ model.head).to(torch.float32)
    return lay.relayout(out, (lay.btd[0], lay.vocab_out),
                        (lay.logits[0], lay.logits[2]))


def forward(model: LM, tokens: torch.Tensor, policy=None, *,
            return_cache: bool = False):
    """tokens (B, S) int -> (hidden (B, S, D) after the final norm, aux,
    cache). ``aux`` is the float32 mean over layers of the MoE
    load-balance loss (a dense model's is 0); ``cache`` is (k, v), each
    (L, B, Hkv, S, Dh), when ``return_cache``, else None. Records for
    autograd when grad is enabled, each layer under a checkpoint with
    ``remat="full"``. Under a mesh ``policy``: the rank's tokens and
    hidden states in ``act_btd`` (the sequence-parallel shard) and its
    heads of the cache (module docstring).

    Returns hidden states, not logits: (B, S, V) float32 logits are GiBs
    at vocab 152k; the loss and serving project only what they need."""
    return _forward(model, tokens, _entry(model, tokens, policy, "forward"),
                    return_cache)


def _forward(model: LM, tokens: torch.Tensor, lay: _Layout,
             return_cache: bool):
    cfg = model.cfg
    x = _embed(model, tokens, lay)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    ks, vs, auxes = [], [], []
    for blk in model.blocks:
        if remat and not return_cache:
            # no draws in a layer: nothing of the RNG state to keep
            x, aux = checkpoint(_layer_out, x, blk, cfg, positions, lay,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux, (k, v) = _layer(x, blk, cfg, positions, lay)
            if return_cache:
                ks.append(k)
                vs.append(v)
        auxes.append(aux)
    x = _rms_norm(x, model.final_norm)
    aux = (torch.stack(auxes).mean() if cfg.moe is not None else
           torch.zeros((), dtype=torch.float32, device=x.device))
    cache = (torch.stack(ks), torch.stack(vs)) if return_cache else None
    return x, aux, cache


@torch.no_grad()
def full_logits(model: LM, hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) float32. Small-vocab / test use only."""
    return (hidden @ model.head).to(torch.float32)


def _chunk_nll(h_c: torch.Tensor, y_c: torch.Tensor, head: torch.Tensor,
               lay: _Layout) -> torch.Tensor:
    """Summed cross-entropy of one chunk: logsumexp(h @ head) - <h,
    head[:, y]>, from the model-dtype inputs with float32 logits. A bf16
    product of two bf16 values is exact in float32, so upcasting the
    operands and multiplying in float32 gives the reference's bf16-input,
    float32-accumulated ``jnp.dot(..., preferred_element_type=float32)``
    up to the order of the sums. The float32 copy of the head lives only
    while the chunk runs.

    Under a mesh ``head`` holds the rank's vocabulary columns (``p_head``)
    and h_c the rank's batch with its whole sequence: the logsumexp is the
    ``pmax`` of the local maxima plus the log of the ``psum`` of the local
    exp sums over the vocabulary's axes, and the label term is taken on
    the rank whose columns hold the label, then ``psum``'d. The result is
    the same on every rank of those axes."""
    logits = torch.matmul(h_c.to(torch.float32), head.to(torch.float32))
    vocab = lay.vocab_out
    if lay.policy.axes_size(vocab) == 1:
        lse = torch.logsumexp(logits, dim=-1)                  # (bc, S)
        # the label columns of the (D, V) head, not a gather on the logits
        w_y = emb_lib.gather_rows(head, y_c.reshape(-1), 1).reshape(
            head.shape[0], *y_c.shape)                         # (D, bc, S)
        correct = torch.einsum("bsd,dbs->bs", h_c.to(torch.float32),
                               w_y.to(torch.float32))
        return (lse - correct).sum()
    from repro_torch.dist import collectives as coll
    pol, v_local = lay.policy, head.shape[1]
    top = coll.pmax(logits.amax(dim=-1), pol, vocab)
    lse = top + torch.log(coll.psum(
        torch.exp(logits - top[..., None]).sum(dim=-1), pol, vocab))
    lid = y_c - pol.axis_index(vocab) * v_local
    mine = (lid >= 0) & (lid < v_local)
    w_y = emb_lib.gather_rows(head, torch.clamp(lid, 0, v_local - 1).reshape(
        -1), 1).reshape(head.shape[0], *y_c.shape)
    correct = torch.einsum("bsd,dbs->bs", h_c.to(torch.float32),
                           w_y.to(torch.float32))
    correct = coll.psum(torch.where(mine, correct, 0.0), pol, vocab)
    return (lse - correct).sum()


def lm_loss(model: LM, batch: dict, policy=None, *, loss_chunk: int = 512
            ) -> torch.Tensor:
    """batch = {"tokens": (B, S), "labels": (B, S)} -> scalar float32
    loss: the mean next-token cross-entropy plus ``aux_loss_weight`` times
    the auxiliary loss.

    The reference's steps: the cross-entropy runs over 8 batch chunks
    when B is a multiple of 8 and ``loss_chunk < S * B``, else over one,
    and with several chunks each runs under a checkpoint, so a chunk's
    (bc, S, V) float32 logits never outlive it in either pass. The chunk
    sums are added in order to a float32 total.

    Under a mesh ``policy`` (the train rules, ``launch/cells.py::
    _lm_rules``) tokens and labels are the rank's batch (B over
    ``act_btd``'s batch axes, the whole sequence): the hidden states are
    gathered from the sequence-parallel residual, each chunk (of the
    rank's B) takes the vocabulary-sharded cross-entropy (``_chunk_nll``),
    and the total is ``psum``'d over the batch axes and divided by the
    global B * S. Every rank returns the same loss, and its backward gives
    each parameter the rank's share of the gradient (module
    docstring)."""
    cfg = model.cfg
    tokens, labels = batch["tokens"], batch["labels"]
    lay = _entry(model, tokens, policy, "lm_loss")
    hidden, aux, _ = _forward(model, tokens, lay, return_cache=False)
    batch_axes = lay.btd[0]
    hidden = lay.relayout(hidden, lay.btd, (batch_axes, (), ()))
    b, s, _ = hidden.shape
    n_chunks = 8 if (b % 8 == 0 and loss_chunk < s * b) else 1
    bc = b // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        h_c, y_c = hidden[c * bc:(c + 1) * bc], labels[c * bc:(c + 1) * bc]
        if n_chunks == 1:
            total = total + _chunk_nll(h_c, y_c, model.head, lay)
        else:
            total = total + checkpoint(_chunk_nll, h_c, y_c, model.head, lay,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
    n_tokens = b * s * lay.policy.axes_size(batch_axes)
    if lay.mesh and lay.policy.axes_size(batch_axes) > 1:
        from repro_torch.dist import collectives as coll
        total = coll.psum(total, lay.policy, batch_axes)
    return total / n_tokens + cfg.aux_loss_weight * aux


def init_cache(cfg: LMConfig, batch: int, dtype=None, device="cuda") -> dict:
    """Decode KV cache: (L, B, Hkv, max_seq, Dh) k and v, and the fill
    ``length`` (a Python int: the host decides where the next token goes)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


@torch.no_grad()
def decode_step(model: LM, cache: dict, tokens: torch.Tensor, policy=None):
    """One decode step. tokens (B,) int -> (logits (B, V) float32, cache).

    Writes the new position's k and v into ``cache`` in place, at
    ``cache["length"]``, and returns the same dict with ``length`` one
    more. Raises when the cache is full (the reference clamps the write
    index and overwrites the last slot).

    Under a mesh ``policy`` (the decode rules, ``launch/cells.py::
    _lm_rules``): the rank's tokens and logits, and a cache in the
    ``kv_cache`` layout (``relayout_cache`` moves prefill's there); the
    rank that owns position ``length`` writes it, each rank attends over
    its shard of the sequence, and the shards merge by log-sum-exp."""
    cfg = model.cfg
    pos = int(cache["length"])
    s_local = cache["k"].shape[3]

    def room(lay):
        n = s_local * lay.policy.axes_size(lay.kv[3])
        if pos >= n:
            raise ValueError(f"the KV cache is full: length {pos} == "
                             f"max_seq {n}")

    lay = _entry(model, tokens, policy, "decode_step", decode=True,
                 check=room, step=pos)
    seq = lay.kv[3]
    n_seq = lay.policy.axes_size(seq)
    lo = lay.policy.axis_index(seq) * s_local
    b = tokens.shape[0]
    x = _embed(model, tokens[:, None], lay)                  # (B, 1, D)
    positions = torch.full((1,), pos, dtype=torch.int64,
                           device=tokens.device)
    for i, blk in enumerate(model.blocks):
        kc, vc = cache["k"][i], cache["v"][i]
        h = _rms_norm(x, blk.ln1)
        q, k, v = _project_qkv(h, blk, cfg, positions, lay)
        if lo <= pos < lo + s_local:
            kc[:, :, pos - lo] = k[:, :, 0]
            vc[:, :, pos - lo] = v[:, :, 0]
        rep = q.shape[1] // kc.shape[1]
        kr, vr = attn.repeat_kv(kc, rep), attn.repeat_kv(vc, rep)
        if n_seq == 1:
            o = attn.decode_attention(q[:, :, 0, :], kr, vr, pos + 1)
        else:
            o = attn.merge_decode(*attn.decode_attention_shard(
                q[:, :, 0, :], kr, vr, pos + 1, lo), lay.policy, seq,
                out_dtype=q.dtype)
        x = x + lay.row_parallel(o.reshape(b, 1, -1), blk.wo,
                                 (lay.btd[0], (), lay.heads),
                                 lay.row_attn).to(x.dtype)
        f, _ = _ffn(_rms_norm(x, blk.ln2), blk, cfg, lay)  # aux dropped
        x = x + f.to(x.dtype)
    x = _rms_norm(x[:, 0, :], model.final_norm)
    logits = _logits(model, x, lay)
    cache["length"] = pos + 1
    return logits, cache


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor, policy=None):
    """Prefill: a full forward that also fills the KV cache.

    tokens (B, S) -> (last-position logits (B, V) float32, cache) with the
    cache padded to ``max_seq`` and ``length`` S. Under a mesh: the rank's
    tokens (the batch over ``act_btd``'s batch axes), its logits in the
    ``logits`` layout and the cache in ``kv_cache``'s (the rank's heads
    gathered where the rule replicates them)."""
    cfg = model.cfg
    s = tokens.shape[1]

    def fits(lay):
        if s > cfg.max_seq:
            raise ValueError(f"prompt of {s} tokens exceeds max_seq "
                             f"{cfg.max_seq}")

    lay = _entry(model, tokens, policy, "prefill", check=fits)
    hidden, _, (k, v) = _forward(model, tokens, lay, return_cache=True)
    if lay.mesh:
        src = ((), lay.attn_in[0], lay.heads, (), ())
        pad = (0, 0, 0, cfg.max_seq - s)
        cache = {name: lay.relayout(torch.nn.functional.pad(t, pad), src,
                                    "kv_cache")
                 for name, t in (("k", k), ("v", v))}
        cache["length"] = s
        # the last position lives on the sequence's last shard
        last = lay.relayout(hidden[:, -1:, :], lay.btd,
                            (lay.btd[0], (), ()))[:, -1, :]
    else:
        cache = init_cache(cfg, tokens.shape[0], dtype=k.dtype,
                           device=k.device)
        cache["k"][:, :, :, :s] = k
        cache["v"][:, :, :, :s] = v
        cache["length"] = s
        last = hidden[:, -1, :]
    return _logits(model, last, lay), cache


def relayout_cache(cache: dict, src, dst) -> dict:
    """A cache in policy ``src``'s ``kv_cache`` layout (``prefill``'s)
    moved to policy ``dst``'s (the decode rules'): for the decode rule
    sets of ``launch/cells.py::_lm_rules`` a local slice of the sequence,
    and for a long context also a gather of the batch over the data axes.
    The two policies share one mesh. The new cache is a copy: decode
    writes into it in place, and ``cache`` stays as it was."""
    return {name: dst.relayout(cache[name], src.rules["kv_cache"],
                               dst.rules["kv_cache"]).clone()
            for name in ("k", "v")} | {"length": cache["length"]}


@torch.no_grad()
def greedy(logits: torch.Tensor, policy=None) -> torch.Tensor:
    """The greedy tokens of float32 logits (B, V) -> (B,) int64: the
    argmax over the whole vocabulary, ties to the lowest id. Under a mesh
    the logits are the rank's vocabulary columns (the ``logits``
    layout): each rank's (max, lowest index) is reduced over the
    vocabulary's axes, and every rank of them returns the same tokens."""
    if not _meshed(policy):
        return logits.argmax(-1)
    axes = policy.axes("logits")[2]
    best, arg = logits.max(-1)              # the first maximal index
    ids = arg + policy.axis_index(axes) * logits.shape[-1]
    rows = (axes, ())
    vals = policy.relayout(best[None], rows, ((), ()))   # (shards, B)
    cand = policy.relayout(ids[None], rows, ((), ()))
    top = vals.max(0).values
    lowest = torch.where(vals == top, cand, torch.iinfo(cand.dtype).max)
    return lowest.min(0).values

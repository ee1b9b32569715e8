"""Decoder-only LM transformer (dense: GQA, RoPE, qk-norm, QKV bias,
SwiGLU; and MoE) with train (``lm_loss``), prefill and decode entry points.

Twin of ``src/repro/models/transformer.py`` for one device. The reference
keeps its parameters as a pytree with a leading (L,) layer axis and runs
the stack as one ``lax.scan``; here the model is an ``LM`` module holding
one ``Block`` per layer, run by a Python loop. Weight matrices keep the
reference's (in, out) layout and are used as ``x @ w``, so
``models/convert.py`` copies the reference's arrays as they are.

The functions take no ``ShardingPolicy``: on one device every
``policy.constrain`` of the reference is a no-op. ``LMConfig`` drops
``scan_layers``, which chooses how JAX traces the layer stack and means
nothing to eager PyTorch. With ``moe`` set each layer's FFN is
``models/moe.py``'s (the reference's mesh-less path) and ``forward``'s aux
is the mean of the layers' load-balance losses. ``remat="full"`` (the
default, as in the reference) runs each layer under
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

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
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


def init_params(cfg: LMConfig, generator: torch.Generator,
                device="cuda") -> LM:
    """An ``LM`` on ``device`` with weights drawn at the reference's
    scales: each matrix N(0, 1) * fan_in^-0.5 (the embedding N(0, 1)),
    drawn in float32 on the generator's device and cast to ``cfg.dtype``;
    norm scales 1, biases 0; an MoE layer's experts by
    ``models/moe.py::draw_moe_params_`` (router in float32). The draws are
    torch's, not JAX's: to hold the port against the reference, convert
    the reference's own arrays (``models/convert.py``)."""
    model = LM(cfg, device)
    d, f = cfg.d_model, cfg.d_ff
    nhd = cfg.n_heads * cfg.head_dim

    def normal(param, scale):
        x = torch.randn(param.shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        param.copy_((x * scale).to(cfg.dtype))

    with torch.no_grad():
        for blk in model.blocks:
            for name, scale in (("wq", d ** -0.5), ("wk", d ** -0.5),
                                ("wv", d ** -0.5), ("wo", nhd ** -0.5),
                                ("w_in", d ** -0.5), ("w_gate", d ** -0.5),
                                ("w_out", f ** -0.5)):
                if hasattr(blk, name):
                    normal(getattr(blk, name), scale)
            if cfg.moe is not None:
                moe_lib.draw_moe_params_(blk.moe, generator)
            for name in ("ln1", "ln2", "q_norm", "k_norm"):
                if hasattr(blk, name):
                    getattr(blk, name).fill_(1)
            for name in ("bq", "bk", "bv"):
                if hasattr(blk, name):
                    getattr(blk, name).zero_()
        normal(model.embed, 1.0)
        normal(model.head, d ** -0.5)
        model.final_norm.fill_(1)
    return model


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
                 positions: torch.Tensor):
    """x (B, S, D) -> q (B,H,S,Dh), k/v (B,Hkv,S,Dh) with RoPE applied."""
    b, s, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = _rms_norm(q, p.q_norm)
        k = _rms_norm(k, p.k_norm)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    return q, k, v


def _ffn(h: torch.Tensor, p: Block, cfg: LMConfig):
    """The block's FFN on h (B, S, D) -> (out, aux): the dense SwiGLU with a
    None aux, or the MoE FFN and its load-balance loss."""
    if cfg.moe is not None:
        return p.moe(h, cfg.moe)
    return (torch.nn.functional.silu(h @ p.w_gate) * (h @ p.w_in)
            ) @ p.w_out, None


def _layer(x: torch.Tensor, p: Block, cfg: LMConfig,
           positions: torch.Tensor):
    """One transformer block. x (B, S, D) -> (x', aux, (k, v)); aux is
    None in a dense block."""
    h = _rms_norm(x, p.ln1)
    q, k, v = _project_qkv(h, p, cfg, positions)
    if cfg.attn_impl == "flash":
        # the kernel reads KV head h // n_rep in place: no repeated copy
        o = kops.flash_attention(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=True)
    else:
        rep = cfg.n_heads // cfg.n_kv_heads
        o = attn.chunked_attention(q, attn.repeat_kv(k, rep),
                                   attn.repeat_kv(v, rep),
                                   chunk=min(cfg.attn_chunk, x.shape[1]))
    b, s, _ = x.shape
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.head_dim)
    x = x + (o @ p.wo).to(x.dtype)
    f, aux = _ffn(_rms_norm(x, p.ln2), p, cfg)
    x = x + f.to(x.dtype)
    return x, aux, (k, v)


def _layer_out(x: torch.Tensor, p: Block, cfg: LMConfig,
               positions: torch.Tensor):
    return _layer(x, p, cfg, positions)[:2]


def forward(model: LM, tokens: torch.Tensor, *, return_cache: bool = False):
    """tokens (B, S) int -> (hidden (B, S, D) after the final norm, aux,
    cache). ``aux`` is the float32 mean over layers of the MoE
    load-balance loss (a dense model's is 0); ``cache`` is (k, v), each
    (L, B, Hkv, S, Dh), when ``return_cache``, else None. Records for autograd when grad is enabled, each layer under
    a checkpoint with ``remat="full"``.

    Returns hidden states, not logits: (B, S, V) float32 logits are GiBs
    at vocab 152k; the loss and serving project only what they need."""
    cfg = model.cfg
    x = model.embed[tokens]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    ks, vs, auxes = [], [], []
    for blk in model.blocks:
        if remat and not return_cache:
            # no draws in a layer: nothing of the RNG state to keep
            x, aux = checkpoint(_layer_out, x, blk, cfg, positions,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux, (k, v) = _layer(x, blk, cfg, positions)
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


def _chunk_nll(h_c: torch.Tensor, y_c: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    """Summed cross-entropy of one chunk: logsumexp(h @ head) - <h,
    head[:, y]>, from the model-dtype inputs with float32 logits. A bf16
    product of two bf16 values is exact in float32, so upcasting the
    operands and multiplying in float32 gives the reference's bf16-input,
    float32-accumulated ``jnp.dot(..., preferred_element_type=float32)``
    up to the order of the sums. The float32 copy of the head lives only
    while the chunk runs."""
    logits = torch.matmul(h_c.to(torch.float32), head.to(torch.float32))
    lse = torch.logsumexp(logits, dim=-1)                      # (bc, S)
    # the label columns of the (D, V) head, not a gather on the logits
    w_y = head.index_select(1, y_c.reshape(-1)).reshape(
        head.shape[0], *y_c.shape)                             # (D, bc, S)
    correct = torch.einsum("bsd,dbs->bs", h_c.to(torch.float32),
                           w_y.to(torch.float32))
    return (lse - correct).sum()


def lm_loss(model: LM, batch: dict, *, loss_chunk: int = 512
            ) -> torch.Tensor:
    """batch = {"tokens": (B, S), "labels": (B, S)} -> scalar float32
    loss: the mean next-token cross-entropy plus ``aux_loss_weight`` times
    the auxiliary loss.

    The reference's steps: the cross-entropy runs over 8 batch chunks
    when B is a multiple of 8 and ``loss_chunk < S * B``, else over one,
    and with several chunks each runs under a checkpoint, so a chunk's
    (bc, S, V) float32 logits never outlive it in either pass. The chunk
    sums are added in order to a float32 total."""
    cfg = model.cfg
    hidden, aux, _ = forward(model, batch["tokens"])
    b, s, _ = hidden.shape
    labels = batch["labels"]
    n_chunks = 8 if (b % 8 == 0 and loss_chunk < s * b) else 1
    bc = b // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n_chunks):
        h_c, y_c = hidden[c * bc:(c + 1) * bc], labels[c * bc:(c + 1) * bc]
        if n_chunks == 1:
            total = total + _chunk_nll(h_c, y_c, model.head)
        else:
            total = total + checkpoint(_chunk_nll, h_c, y_c, model.head,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
    return total / (b * s) + cfg.aux_loss_weight * aux


def init_cache(cfg: LMConfig, batch: int, dtype=None, device="cuda") -> dict:
    """Decode KV cache: (L, B, Hkv, max_seq, Dh) k and v, and the fill
    ``length`` (a Python int: the host decides where the next token goes)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cfg.max_seq, cfg.head_dim)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "length": 0}


@torch.no_grad()
def decode_step(model: LM, cache: dict, tokens: torch.Tensor):
    """One decode step. tokens (B,) int -> (logits (B, V) float32, cache).

    Writes the new position's k and v into ``cache`` in place, at
    ``cache["length"]``, and returns the same dict with ``length`` one
    more. Raises when the cache is full (the reference clamps the write
    index and overwrites the last slot)."""
    cfg = model.cfg
    pos = int(cache["length"])
    if pos >= cache["k"].shape[3]:
        raise ValueError(f"the KV cache is full: length {pos} == max_seq "
                         f"{cache['k'].shape[3]}")
    b = tokens.shape[0]
    x = model.embed[tokens][:, None, :]                       # (B, 1, D)
    positions = torch.full((1,), pos, dtype=torch.int64,
                           device=tokens.device)
    rep = cfg.n_heads // cfg.n_kv_heads
    for i, blk in enumerate(model.blocks):
        kc, vc = cache["k"][i], cache["v"][i]
        h = _rms_norm(x, blk.ln1)
        q, k, v = _project_qkv(h, blk, cfg, positions)
        kc[:, :, pos] = k[:, :, 0]
        vc[:, :, pos] = v[:, :, 0]
        o = attn.decode_attention(q[:, :, 0, :], attn.repeat_kv(kc, rep),
                                  attn.repeat_kv(vc, rep), pos + 1)
        x = x + (o.reshape(b, 1, -1) @ blk.wo).to(x.dtype)
        f, _ = _ffn(_rms_norm(x, blk.ln2), blk, cfg)     # the aux is dropped
        x = x + f.to(x.dtype)
    x = _rms_norm(x[:, 0, :], model.final_norm)
    logits = (x @ model.head).to(torch.float32)
    cache["length"] = pos + 1
    return logits, cache


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor):
    """Prefill: a full forward that also fills the KV cache.

    tokens (B, S) -> (last-position logits (B, V) float32, cache) with the
    cache padded to ``max_seq`` and ``length`` S."""
    cfg = model.cfg
    s = tokens.shape[1]
    if s > cfg.max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq "
                         f"{cfg.max_seq}")
    hidden, _, (k, v) = forward(model, tokens, return_cache=True)
    cache = init_cache(cfg, tokens.shape[0], dtype=k.dtype, device=k.device)
    cache["k"][:, :, :, :s] = k
    cache["v"][:, :, :, :s] = v
    cache["length"] = s
    last = (hidden[:, -1, :] @ model.head).to(torch.float32)
    return last, cache

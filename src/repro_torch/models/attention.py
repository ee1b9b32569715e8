"""Attention in plain PyTorch: chunked (online-softmax) causal attention,
the O(S^2)-memory oracle and one-position decode attention.

Twin of ``src/repro/models/attention.py``. None of it is a kernel in the
reference either: ``chunked_attention`` is the transformer's default
``attn_impl``, and on the card it is the plain whole-model comparison for
the hand-written ``flash_attention`` kernel (``kernels/ops.py``).

``chunked_attention`` never materializes the (S, S) score matrix: it walks
the KV chunks carrying the running (max, denominator, accumulator) triple,
FlashAttention's recurrence written as tensor ops, so the peak live
intermediate is (B, H, S_q, chunk). ``decode_attention`` scores one query
position against a KV cache with positions at or past ``length`` masked.

Split-KV decode (a cache whose sequence is sharded over mesh axes, the
decode rules' ``kv_cache``): ``decode_attention_shard`` attends over one
rank's positions and returns (o, m, l), its output normalized over the
shard, the shard's max score and its softmax denominator at that max; a
shard with no valid position gives (0, -1e30, 0). ``merge_decode``
combines the ranks' triples by log-sum-exp: with M the max of the m's,
each o weighs exp(m - M) * l.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, Hkv, S, Dh) -> (B, Hkv*n_rep, S, Dh) for GQA: head h reads KV
    head h // n_rep."""
    if n_rep == 1:
        return x
    b, h, s, d = x.shape
    return x[:, :, None].expand(b, h, n_rep, s, d).reshape(
        b, h * n_rep, s, d)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      *, chunk: int = 512, causal: bool = True
                      ) -> torch.Tensor:
    """q (B,H,Sq,Dh), k/v (B,H,Skv,Dh) -> (B,H,Sq,Dh).

    KV is padded to a chunk multiple and the padding masked. Causal
    masking assumes q positions are the last Sq positions of the kv range
    (standard prefill/train layout).
    """
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    skv_pad = -(-skv // chunk) * chunk
    if skv_pad != skv:
        pad = (0, 0, 0, skv_pad - skv)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    scale = dh ** -0.5
    out_dtype = q.dtype
    q = (q * scale).to(torch.float32)
    q_pos = torch.arange(sq, device=q.device) + (skv - sq)

    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, sq, dh), dtype=torch.float32, device=q.device)
    for idx in range(skv_pad // chunk):
        kc = k[:, :, idx * chunk:(idx + 1) * chunk].to(torch.float32)
        vc = v[:, :, idx * chunk:(idx + 1) * chunk].to(torch.float32)
        s = torch.einsum("bhqd,bhcd->bhqc", q, kc)
        kv_pos = idx * chunk + torch.arange(chunk, device=q.device)
        if causal:
            mask = (q_pos[:, None] >= kv_pos[None, :]) & (kv_pos < skv)
        else:
            mask = (kv_pos < skv).expand(sq, chunk)
        s = torch.where(mask[None, None], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqc,bhcd->bhqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(out_dtype)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Reference O(S^2)-memory attention (the tests' oracle)."""
    sq, dh = q.shape[2], q.shape[3]
    skv = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * dh ** -0.5
    if causal:
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
        mask = q_pos[:, None] >= torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int) -> torch.Tensor:
    """One-position attention against a cache.

    q (B, H, Dh); k_cache/v_cache (B, H, Smax, Dh) (already GQA-repeated);
    length: the cache fill (positions >= length are masked). The whole
    cache as one shard of ``decode_attention_shard``."""
    return decode_attention_shard(q, k_cache, v_cache, length, 0)[0].to(
        q.dtype)


def decode_attention_shard(q: torch.Tensor, k_shard: torch.Tensor,
                           v_shard: torch.Tensor, length: int, offset: int
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One-position attention over a shard of the cache's sequence.

    q (B, H, Dh); k_shard/v_shard (B, H, S_local, Dh) (already
    GQA-repeated) holding positions ``offset`` to ``offset + S_local - 1``;
    positions at or past ``length`` are masked. -> (o (B, H, Dh) in float32
    normalized over the shard, m (B, H), l (B, H))."""
    s_local, dh = k_shard.shape[2], k_shard.shape[3]
    s = torch.einsum("bhd,bhsd->bhs", (q * dh ** -0.5).to(torch.float32),
                     k_shard.to(torch.float32))
    valid = (offset + torch.arange(s_local, device=q.device)
             )[None, None, :] < length
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhs,bhsd->bhd", p, v_shard.to(torch.float32))
    return o / torch.clamp(l, min=1e-30)[..., None], m, l


def merge_decode(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor, policy,
                 axes, out_dtype=None) -> torch.Tensor:
    """Merge the shards' ``decode_attention_shard`` triples over the mesh
    ``axes`` by log-sum-exp -> (B, H, Dh) in ``out_dtype`` (the model's
    bf16 or float32; default o's), the same on every rank of them."""
    from repro_torch.dist import collectives as coll
    top = coll.pmax(m, policy, axes)
    w = torch.exp(m - top) * l
    both = coll.psum(torch.cat([o * w[..., None], w[..., None]], dim=-1),
                     policy, axes)                     # one collective
    out = both[..., :-1] / torch.clamp(both[..., -1:], min=1e-30)
    return out.to(out_dtype or o.dtype)

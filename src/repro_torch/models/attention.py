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
    length: the cache fill (positions >= length are masked).
    """
    smax, dh = k_cache.shape[2], k_cache.shape[3]
    out_dtype = q.dtype
    s = torch.einsum("bhd,bhsd->bhs", (q * dh ** -0.5).to(torch.float32),
                     k_cache.to(torch.float32))
    valid = torch.arange(smax, device=q.device)[None, None, :] < length
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhs,bhsd->bhd", p, v_cache.to(torch.float32))
    return (out / torch.clamp(l, min=1e-30)).to(out_dtype)

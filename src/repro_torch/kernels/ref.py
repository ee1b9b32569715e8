"""Plain PyTorch versions of the hand-written CUDA kernels.

Twins of ``src/repro/kernels/ref.py:16-93``. Each function computes
what its kernel computes, by the kernel's own algorithm, in ordinary
tensor ops: the CPU path of ``kernels/ops.py`` runs them, and
``chip_smoke.py`` holds each CUDA kernel against them on the card.

SRP codes travel as int32 *bit views* of the reference's uint32 words:
CPU torch has no ``>>`` or ``-`` on uint32 and no popcount op, and the
bits are what matter. ``codes.numpy().view(np.uint32)`` recovers the
reference's words exactly.

Float sums that a kernel must reproduce bit for bit (``srp_hash``'s
scores, ``fused_scan``'s quantized inner products, ``ip_topk``'s scores)
run one rounded multiply and one rounded add per term, in index order,
exactly as the kernels do with ``__fmul_rn`` / ``__fadd_rn``.
``flash_attention`` is the one exception: its kernel sums in another
order than this O(S^2) version, so the two agree within a stated
tolerance, not bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ip_topk import BLOCK_N
from repro_torch.models.attention import repeat_kv

BIG_HAMMING = 1 << 30   # distance given to masked rows: behind every live row

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F
_WORD = 1 << 32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of int32 ``x`` (SWAR on int64)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & _M1)
    v = (v & _M2) + ((v >> 2) & _M2)
    v = (v + (v >> 4)) & _M4
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_scores(query_codes: torch.Tensor,
                   item_codes: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances: (q, W) x (n, W) int32 codes -> (q, n)
    int32, ``sum_w popcount(query[i, w] ^ item[j, w])``."""
    x = torch.bitwise_xor(query_codes[:, None, :], item_codes[None, :, :])
    return popcount32(x).sum(dim=-1).to(torch.int32)


def _words_to_int32(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor with the same bits."""
    return torch.where(words >= (1 << 31), words - _WORD, words).to(
        torch.int32)


def pack_signs(signs: torch.Tensor) -> torch.Tensor:
    """Boolean signs (n, B) -> int32 codes (n, B // 32); bit j of word w is
    sign ``32 * w + j``."""
    n, b = signs.shape
    grouped = signs.reshape(n, b // 32, 32).to(torch.int64)
    pow2 = torch.ones(32, dtype=torch.int64, device=signs.device) << \
        torch.arange(32, device=signs.device)
    return _words_to_int32((grouped * pow2).sum(dim=-1))


def index_order_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_i a[..., i] * b[..., i]`` over broadcast leading dims, one
    running float32 sum per output over i = 0..d-1, each product and each
    sum rounded on its own (the kernels' ``__fmul_rn`` / ``__fadd_rn``
    loop). Elementwise per output, so an output never depends on what else
    shares the call (a GEMM's blocking may)."""
    s = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                    dtype=torch.float32, device=a.device)
    for i in range(a.shape[-1]):
        s = s + a[..., i] * b[..., i]
    return s


def srp_scores(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """``x @ proj`` summed as the kernel sums it: one running sum per
    output over i = 0..d-1, each product and each sum rounded on its own,
    so that the kernel's codes equal ``srp_hash``'s bit for bit."""
    return index_order_dot(x[:, None, :], proj.T[None])


def srp_hash(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """SRP sign codes, bit packed: x (n, d) f32, proj (d, B) f32 ->
    (n, B // 32) int32. Bit j of word w is set iff
    ``<x, proj[:, 32 w + j]> >= 0`` (so -0.0 sets it and NaN does not)."""
    return pack_signs(srp_scores(x, proj) >= 0.0)


def nearest_rows(dist: torch.Tensor, n_cand: int) -> torch.Tensor:
    """The ``n_cand`` columns of lowest ``dist`` in each row, ascending,
    the lower column first on ties -> (rows, n_cand) int32. That is the
    order of ``lax.top_k(-dist)`` and of the kernels' iterated argmin;
    selecting on the unique int64 key ``dist * n + column`` gives exactly
    it (``torch.topk`` alone promises neither the set nor the order)."""
    n = dist.shape[-1]
    key = dist.to(torch.int64) * n + torch.arange(n, device=dist.device)
    best = torch.topk(key, n_cand, dim=-1, largest=False, sorted=True)
    return (best.values % n).to(torch.int32)


def hamming_nearest(ucodes: torch.Tensor, item_codes: torch.Tensor,
                    item_mask: torch.Tensor, n_cand: int) -> torch.Tensor:
    """Each lane's ``n_cand`` nearest rows of one tile: ucodes (C, W) and
    item_codes (T, W) int32, item_mask (T,) bool -> (C, n_cand) int32 tile
    rows, ascending by Hamming distance, the lower row first on ties;
    masked rows get ``BIG_HAMMING`` and so rank behind every live row (the
    reference's ``hamming_scores`` then ``lax.top_k(-dist, n_cand)``,
    ``src/repro/core/sa_alsh.py:319-321``)."""
    dist = hamming_scores(ucodes, item_codes)
    dist = torch.where(item_mask[None, :], dist, BIG_HAMMING)
    return nearest_rows(dist, n_cand)


def fused_scan(ucodes: torch.Tensor, item_codes: torch.Tensor,
               item_mask: torch.Tensor, qitems: torch.Tensor,
               qscale: torch.Tensor, users: torch.Tensor,
               n_cand: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused int8 sketch scan of one item tile (twin of the reference's
    ``ref.fused_scan``): ucodes (C, W) int32, item_codes (T, W) int32,
    item_mask (T,) bool, qitems (T, d) int8, qscale (T,) f32, users
    (C, d) f32 -> (cand (C, n_cand) int32 tile rows, qips (C, n_cand) f32).

    Candidates ascend by Hamming distance, the lower row first on ties;
    masked rows get ``BIG_HAMMING`` and so rank behind every live row but
    still give deterministic candidates. ``qips[c, p]`` is
    ``<float(qitems[r]), users[c]> * qscale[r]`` for ``r = cand[c, p]``:
    the scale multiplies after the integer-valued dot, which is what the
    error ball of ``core/sa_alsh.py::_tile_beat_int8`` assumes."""
    cand = hamming_nearest(ucodes, item_codes, item_mask, n_cand)
    rows = cand.long()
    qvecs = qitems[rows].to(torch.float32)               # (C, n_cand, d)
    qips = index_order_dot(qvecs, users[:, None, :]) * qscale[rows]
    return cand, qips


def topk_stable(vals: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row, descending, the lower position first
    among equal values (``lax.top_k``'s rule; ``torch.topk`` promises no
    order): (values, int64 positions), by a stable descending sort."""
    v, pos = torch.sort(vals, dim=-1, descending=True, stable=True)
    return v[..., :k], pos[..., :k]


def ip_topk(queries: torch.Tensor, items: torch.Tensor,
            k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k inner products: queries (q, d), items (n, d) -> (vals
    (q, k) f32 descending, ids (q, k) int32), the lower id first among
    equal values. For finite scores this is what ``merge_topk`` of the
    kernel's per-split lists gives: each split keeps its equal values in
    id order, and the splits come in id order."""
    scores = index_order_dot(queries[:, None, :], items[None, :, :])
    vals, ids = topk_stable(scores, k)
    return vals, ids.to(torch.int32)


def ip_topk_partials(queries: torch.Tensor, items: torch.Tensor, k: int,
                     splits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the CUDA ``ip_topk`` kernel's raw output: the items cut
    into ``splits`` ranges of whole ``BLOCK_N``-item tiles (split s covers
    tiles [s * per, (s + 1) * per) with per = ceil(tiles / splits), clipped
    to n, possibly empty), each reduced to its top-k by ``index_order_dot``
    and ``topk_stable`` -> (vals (q, splits, k) f32, ids (q, splits, k)
    int32 global rows), padded with (-inf, -1) where a split holds fewer
    than k items."""
    nq, n = queries.shape[0], items.shape[0]
    n_tiles = -(-n // BLOCK_N)
    per = -(-n_tiles // splits) * BLOCK_N               # items per split
    scores = index_order_dot(queries[:, None, :], items[None, :, :])
    vals = torch.full((nq, splits, k), -torch.inf, device=queries.device)
    ids = torch.full((nq, splits, k), -1, dtype=torch.int32,
                     device=queries.device)
    for s in range(splits):
        lo, hi = min(s * per, n), min((s + 1) * per, n)
        v, pos = topk_stable(scores[:, lo:hi], min(k, hi - lo))
        vals[:, s, :v.shape[1]] = v
        ids[:, s, :v.shape[1]] = (pos + lo).to(torch.int32)
    return vals, ids


def merge_topk(vals: torch.Tensor, ids: torch.Tensor, k: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge per-split top-k lists (q, splits, k) into the top-k of each
    row (q, k), by a stable descending sort over the splits' lists in
    order (twin of the reference's ``ops._merge_topk``): the lower id first
    among equal values when each list is in (value desc, id asc) order and
    the splits come in id order."""
    best, pos = topk_stable(vals.reshape(vals.shape[0], -1), k)
    return best, ids.reshape(ids.shape[0], -1).gather(1, pos)


def kv_repeats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The GQA factor n_rep = H // Hkv of q (B, H, S, Dh) and k, v
    (B, Hkv, S, Dh); raises ``ValueError`` unless k and v have one shape,
    B, S and Dh equal q's, and H % Hkv == 0."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k and v must be 4-D with k and v of one "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    (b, h, s, dh), hkv = q.shape, k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, dh):
        raise ValueError(f"k and v must match q in B, S and Dh, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if hkv < 1 or h % hkv:
        raise ValueError(f"q's {h} heads are not a multiple of k's {hkv}")
    return h // hkv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """O(S^2)-memory version of the flash attention kernel (twin of the
    reference's ``ref.flash_attention``): q (B, H, S, Dh), k/v (B, Hkv, S,
    Dh) with H % Hkv == 0 -> (B, H, S, Dh) in q's dtype. k and v are
    repeated to H heads first (``repeat_kv``: head h reads KV head
    h // n_rep), then scores ``q k^T * Dh^-0.5`` in float32, positions
    above the diagonal set to -1e30 when ``causal``, softmax and the
    product with v in float32."""
    n_rep = kv_repeats(q, k, v)
    k, v = repeat_kv(k, n_rep), repeat_kv(v, n_rep)
    dh = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * dh ** -0.5
    if causal:
        sq, skv = q.shape[2], k.shape[2]
        q_pos = torch.arange(sq, device=q.device) + (skv - sq)
        mask = q_pos[:, None] >= torch.arange(skv, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p,
                        v.to(torch.float32)).to(q.dtype)

"""Plain PyTorch versions of the hand-written CUDA kernels.

Twins of ``src/repro/kernels/ref.py:16-34``. Each function computes what
its kernel computes, by the kernel's own algorithm, in ordinary tensor
ops: the CPU path of ``kernels/ops.py`` runs them, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.

SRP codes travel as int32 *bit views* of the reference's uint32 words:
CPU torch has no ``>>`` or ``-`` on uint32 and no popcount op, and the
bits are what matter. ``codes.numpy().view(np.uint32)`` recovers the
reference's words exactly.
"""

from __future__ import annotations

import torch

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


def srp_scores(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """``x @ proj`` summed in the kernel's order: one running sum per
    output, over i = 0..d-1. Elementwise per row, so a row's scores never
    depend on which other rows share the call (a GEMM's blocking may)."""
    s = torch.zeros(x.shape[0], proj.shape[1], dtype=torch.float32,
                    device=x.device)
    for i in range(x.shape[1]):
        s = s + x[:, i, None] * proj[i]
    return s


def srp_hash(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """SRP sign codes, bit packed: x (n, d) f32, proj (d, B) f32 ->
    (n, B // 32) int32. Bit j of word w is set iff
    ``<x, proj[:, 32 w + j]> >= 0`` (so -0.0 sets it and NaN does not)."""
    return pack_signs(srp_scores(x, proj) >= 0.0)

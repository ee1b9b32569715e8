"""Wrapper of the CUDA flash attention kernels (``csrc/flash_attention.cu``).

Port of ``src/repro/kernels/flash_attention.py:81-120`` (the Pallas
``flash_attention``): forward attention with an online softmax, causal or
full, on q (B, H, S, Dh) and k, v (B, Hkv, S, Dh) with H % Hkv == 0. Query
head h reads KV head h // (H // Hkv), the mapping of ``repeat_kv``, in
place; Hkv = H is the reference's own layout. The kernels' note in their
source says what bounds them on an H100 and how they are laid out; this
wrapper checks what it is given, picks the kernel by shape, allocates the
output and launches on PyTorch's current stream. Unlike the Pallas kernel,
which asks for ``S % block == 0``, every route takes any S: it masks the
ragged tail itself.

Routes, by shape, with no fallback between them:

- ``"wgmma"``: bf16 with Dh % 8 == 0 and 16-byte aligned q, k and v; TMA
  loads and ``wgmma`` (the Hopper design);
- ``"mma"``: any other bf16 shape; ``mma.sync``;
- ``"simt"``: float32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

MAX_HEAD_DIM = 128
_MAX_BH = 65535      # grid.y of the mma and simt kernels: one (b, h) a row
_MAX_S = 65535 * 128  # grid.y of the wgmma kernel: one 128-row tile a row
_DTYPES = (torch.bfloat16, torch.float32)
_ROUTES = {"simt": 0, "mma": 1, "wgmma": 2}


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these inputs: "wgmma", "mma" or "simt"."""
    if q.dtype == torch.float32:
        return "simt"
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return "wgmma" if q.shape[-1] % 8 == 0 and aligned else "mma"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q (B, H, S, Dh), k/v (B, Hkv, S, Dh) with H % Hkv == 0, all bf16 or
    all float32, contiguous, on one CUDA device -> (B, H, S, Dh) in the
    same dtype: softmax(q k^T * Dh^-0.5) v, positions above the diagonal
    masked when ``causal``. Raises on anything the kernels do not take."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes bf16 or float32, got "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_input(name, t, q.dtype, 4)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v are on different devices")
    ref.kv_repeats(q, k, v)
    b, h, s, dh = q.shape
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in [1, {MAX_HEAD_DIM}], got {dh}")
    if not 1 <= s <= _MAX_S or not 1 <= b * h <= _MAX_BH:
        raise ValueError(f"need 1 <= S <= {_MAX_S} and 1 <= B * H <= "
                         f"{_MAX_BH}, got {tuple(q.shape)}")
    return _launch(q, k, v, causal, route(q, k, v))


def _launch(q, k, v, causal: bool, kernel: str) -> torch.Tensor:
    """Launch route ``kernel`` on checked inputs and count it."""
    b, h, s, dh = q.shape
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", "flash_attention_launch", 4, 7)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h,
             k.shape[1], s, dh, int(causal), _ROUTES[kernel],
             _build.stream_ptr(q.device))
    _build.check(err, f"flash_attention ({kernel})")
    _build.count_launch("flash_attention")
    if kernel == "wgmma":
        _build.count_launch("flash_attention_wgmma")
    return out

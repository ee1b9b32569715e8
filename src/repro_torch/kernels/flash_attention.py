"""Wrapper of the CUDA flash attention kernel (``csrc/flash_attention.cu``).

Port of ``src/repro/kernels/flash_attention.py:81-120`` (the Pallas
``flash_attention``): forward attention with an online softmax, causal or
full, on (B, H, S, Dh) with KV already repeated to H heads. The kernel's
note in its source says what bounds it on an H100 and how it is laid out;
this wrapper checks what it is given, allocates the output and launches on
PyTorch's current stream. Unlike the Pallas kernel, which asks for
``S % block == 0``, the kernel takes any S: it masks the ragged tail itself.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

MAX_HEAD_DIM = 128
_MAX_BH = 65535      # grid.y holds one (batch, head) pair per block row
_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q/k/v (B, H, S, Dh), all bf16 or all float32, contiguous, on one
    CUDA device -> (B, H, S, Dh) in the same dtype: softmax(q k^T *
    Dh^-0.5) v, positions above the diagonal masked when ``causal``.
    Raises on anything the kernel does not take."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes bf16 or float32, got "
                         f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_input(name, t, q.dtype, 4)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v are on different devices")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k and v must have one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, dh = q.shape
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"head dim must be in [1, {MAX_HEAD_DIM}], got {dh}")
    if s < 1 or not 1 <= b * h <= _MAX_BH:
        raise ValueError(f"need S >= 1 and 1 <= B * H <= {_MAX_BH}, got "
                         f"{tuple(q.shape)}")
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention", "flash_attention_launch", 4, 5)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
             s, dh, int(causal), int(q.dtype == torch.bfloat16),
             _build.stream_ptr(q.device))
    _build.check(err, "flash_attention")
    _build.launch_counts["flash_attention"] += 1
    return out

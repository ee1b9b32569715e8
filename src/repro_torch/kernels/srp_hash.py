"""Wrapper of the CUDA SRP hashing kernel (``csrc/srp_hash.cu``).

Port of ``src/repro/kernels/srp_hash.py:41-59`` (the Pallas ``srp_hash``):
projection, sign test and bit packing in one pass. The kernel's note in
its source says what bounds it on an H100 and how it is laid out; this
wrapper checks what it is given, allocates the output and launches on
PyTorch's current stream.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_MAX_BITS = 1024            # one thread per output bit
_MAX_DIM = 48 * 1024 // 4   # the staged row fits 48 KB of shared memory


def srp_hash(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """x (n, d) f32, proj (d, B) f32 on one CUDA device -> (n, B // 32)
    int32 codes. Raises on anything the kernel does not take."""
    for name, t in (("x", x), ("proj", proj)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 2:
            raise ValueError(f"{name} must be 2-D float32, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.device != proj.device:
        raise ValueError("x and proj are on different devices")
    (n, d), (d2, b) = x.shape, proj.shape
    if d != d2:
        raise ValueError(f"x has {d} columns but proj has {d2} rows")
    if b % 32 != 0 or not 32 <= b <= _MAX_BITS:
        raise ValueError(f"bits must be a multiple of 32 in [32, "
                         f"{_MAX_BITS}], got {b}")
    if not 1 <= d <= _MAX_DIM:
        raise ValueError(f"dim must be in [1, {_MAX_DIM}], got {d}")
    out = torch.empty((n, b // 32), dtype=torch.int32, device=x.device)
    fn = _build.entry("srp_hash", "srp_hash_launch", 3, 3)
    err = fn(x.data_ptr(), proj.data_ptr(), out.data_ptr(), n, d, b,
             _build.stream_ptr(x.device))
    _build.check(err, "srp_hash")
    _build.launch_counts["srp_hash"] += 1
    return out

"""Wrapper of the CUDA SRP hashing kernel (``csrc/srp_hash.cu``).

Port of ``src/repro/kernels/srp_hash.py:41-59`` (the Pallas ``srp_hash``):
projection, sign test and bit packing in one pass, bit for bit equal to
``ref.srp_hash``. The kernel's note in its source says what bounds it on
an H100 and how it is laid out; this wrapper checks what it is given,
allocates the output and launches on PyTorch's current stream.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_MAX_WORDS = 65535          # grid.y covers the output words


def srp_hash(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """x (n, d) f32, proj (d, B) f32 on one CUDA device -> (n, B // 32)
    int32 codes. Raises on anything the kernel does not take."""
    for name, t in (("x", x), ("proj", proj)):
        _build.check_input(name, t, torch.float32, 2)
    if x.device != proj.device:
        raise ValueError("x and proj are on different devices")
    (n, d), (d2, b) = x.shape, proj.shape
    if d != d2:
        raise ValueError(f"x has {d} columns but proj has {d2} rows")
    if b % 32 != 0 or not 1 <= b // 32 <= _MAX_WORDS:
        raise ValueError(f"bits must be a multiple of 32 in [32, "
                         f"{32 * _MAX_WORDS}], got {b}")
    if d < 1:
        raise ValueError(f"dim must be at least 1, got {d}")
    out = torch.empty((n, b // 32), dtype=torch.int32, device=x.device)
    fn = _build.entry("srp_hash", "srp_hash_launch", 3, 3)
    err = fn(x.data_ptr(), proj.data_ptr(), out.data_ptr(), n, d, b,
             _build.stream_ptr(x.device))
    _build.check(err, "srp_hash")
    _build.count_launch("srp_hash")
    return out

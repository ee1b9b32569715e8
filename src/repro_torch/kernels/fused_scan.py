"""Wrapper of the CUDA fused int8 scan kernel (``csrc/fused_scan.cu``).

Port of ``src/repro/kernels/fused_scan.py:113-155`` (the Pallas
``fused_scan_tiles``): Hamming filter, top-``n_cand`` selection and
dequantized int8 inner products of one item tile, per user lane. The
kernel's note in its source says what bounds it on an H100 and how it is
laid out; this wrapper checks what it is given, allocates the outputs and
launches on PyTorch's current stream.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hamming_scan import check_selection


def fused_scan(ucodes: torch.Tensor, item_codes: torch.Tensor,
               item_mask: torch.Tensor, qitems: torch.Tensor,
               qscale: torch.Tensor, users: torch.Tensor, *, n_cand: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """ucodes (C, W) int32, item_codes (T, W) int32, item_mask (T,) bool,
    qitems (T, d) int8, qscale (T,) f32, users (C, d) f32, all on one
    CUDA device -> (cand (C, n_cand) int32, qips (C, n_cand) f32). Raises
    on anything the kernel does not take."""
    args = (("ucodes", ucodes, torch.int32, 2),
            ("item_codes", item_codes, torch.int32, 2),
            ("item_mask", item_mask, torch.bool, 1),
            ("qitems", qitems, torch.int8, 2),
            ("qscale", qscale, torch.float32, 1),
            ("users", users, torch.float32, 2))
    for name, t, dtype, dim in args:
        _build.check_input(name, t, dtype, dim)
    if len({t.device for _, t, _, _ in args}) != 1:
        raise ValueError("fused_scan inputs are on different devices")
    check_selection(ucodes, item_codes, item_mask, n_cand)
    (c, w), t, (c2, d) = ucodes.shape, item_codes.shape[0], users.shape
    if (qitems.shape[0], qscale.shape[0]) != (t, t):
        raise ValueError(f"qitems and qscale must have the tile's {t} rows")
    if qitems.shape[1] != d or c2 != c:
        raise ValueError(f"users {tuple(users.shape)} do not match ucodes "
                         f"({c} lanes) and qitems ({qitems.shape[1]} dims)")
    cand = torch.empty((c, n_cand), dtype=torch.int32, device=users.device)
    qips = torch.empty((c, n_cand), dtype=torch.float32, device=users.device)
    fn = _build.entry("fused_scan", "fused_scan_launch", 8, 5)
    err = fn(ucodes.data_ptr(), item_codes.data_ptr(), item_mask.data_ptr(),
             qitems.data_ptr(), qscale.data_ptr(), users.data_ptr(),
             cand.data_ptr(), qips.data_ptr(), c, t, w, d, n_cand,
             _build.stream_ptr(users.device))
    _build.check(err, "fused_scan")
    _build.count_launch("fused_scan")
    return cand, qips

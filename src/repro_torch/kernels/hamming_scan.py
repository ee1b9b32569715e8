"""Wrapper of the CUDA Hamming kernel (``csrc/hamming_scan.cu``).

Port of ``src/repro/kernels/hamming_scan.py:36-66`` (the Pallas
``hamming_scores``). The kernel's note in its source says what bounds it
on an H100 and how it is laid out; this wrapper checks what it is given,
allocates the output and launches on PyTorch's current stream.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

_MAX_QUERIES = 8 * 65535     # grid.y is limited to 65535 blocks of 8 rows


def hamming_scores(query_codes: torch.Tensor,
                   item_codes: torch.Tensor) -> torch.Tensor:
    """(q, W) x (n, W) int32 codes on one CUDA device -> (q, n) int32
    Hamming distances. Raises on anything the kernel does not take."""
    for name, t in (("query_codes", query_codes), ("item_codes", item_codes)):
        _build.check_input(name, t, torch.int32, 2)
    if query_codes.device != item_codes.device:
        raise ValueError("query_codes and item_codes are on different devices")
    (nq, w), (n, w2) = query_codes.shape, item_codes.shape
    if w != w2:
        raise ValueError(f"code widths differ: {w} vs {w2} words")
    if w < 1 or w > 1024:
        raise ValueError(f"code width must be in [1, 1024] words, got {w}")
    if nq > _MAX_QUERIES:
        raise ValueError(f"at most {_MAX_QUERIES} query rows per launch, "
                         f"got {nq}")
    out = torch.empty((nq, n), dtype=torch.int32, device=query_codes.device)
    fn = _build.entry("hamming_scan", "hamming_scores_launch", 3, 3)
    err = fn(query_codes.data_ptr(), item_codes.data_ptr(), out.data_ptr(),
             nq, n, w, _build.stream_ptr(query_codes.device))
    _build.check(err, "hamming_scores")
    _build.launch_counts["hamming_scores"] += 1
    return out

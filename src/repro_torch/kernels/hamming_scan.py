"""Wrappers of the CUDA Hamming kernels (``csrc/hamming_scan.cu``).

Port of ``src/repro/kernels/hamming_scan.py:36-66`` (the Pallas
``hamming_scores``): ``hamming_scores`` is the dense all-pairs matrix, and
``hamming_nearest`` fuses it with the mask and the ``n_cand``-nearest
selection that the f32 tile scan applies to it (the reference's
``lax.top_k(-dist, n_cand)``, ``src/repro/core/sa_alsh.py:319-321``),
through the selection ``csrc/select.cuh`` shares with ``fused_scan``. The
kernels' note in their source says what bounds them on an H100 and how
they are laid out; these wrappers check what they are given, allocate the
output and launch on PyTorch's current stream.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# The selection of csrc/select.cuh (hamming_nearest and fused_scan): each
# warp counts 32 W + 2 bins in shared memory, and a thread takes at most 16
# rows (the reference's largest tile)
SELECT_MAX_WORDS = 32
SELECT_MAX_ROWS = 4096
_MAX_WORDS = 1024            # the dense kernel stages 8 query rows of W words


def check_codes(query_codes: torch.Tensor,
                item_codes: torch.Tensor) -> int:
    """Raise unless both are contiguous 2-D int32 CUDA tensors on one device
    with one code width; return that width W."""
    for name, t in (("query_codes", query_codes), ("item_codes", item_codes)):
        _build.check_input(name, t, torch.int32, 2)
    if query_codes.device != item_codes.device:
        raise ValueError("query_codes and item_codes are on different devices")
    w, w2 = query_codes.shape[1], item_codes.shape[1]
    if w != w2:
        raise ValueError(f"code widths differ: {w} vs {w2} words")
    return w


def check_selection(ucodes: torch.Tensor, item_codes: torch.Tensor,
                    item_mask: torch.Tensor, n_cand: int) -> None:
    """Raise unless (ucodes, item_codes, item_mask, n_cand) is a selection
    that ``csrc/select.cuh`` takes: W <= 32, 1 <= T <= 4096 and
    1 <= n_cand <= T, the mask a (T,) bool CUDA tensor beside the codes."""
    w = check_codes(ucodes, item_codes)
    _build.check_input("item_mask", item_mask, torch.bool, 1)
    t = item_codes.shape[0]
    if item_mask.device != item_codes.device:
        raise ValueError("item_mask and item_codes are on different devices")
    if item_mask.shape[0] != t:
        raise ValueError(f"item_mask must have the tile's {t} rows, got "
                         f"{item_mask.shape[0]}")
    if not 1 <= w <= SELECT_MAX_WORDS:
        raise ValueError(f"code width must be in [1, {SELECT_MAX_WORDS}] "
                         f"words, got {w}")
    if not 1 <= t <= SELECT_MAX_ROWS:
        raise ValueError(f"the tile must have 1 to {SELECT_MAX_ROWS} rows, "
                         f"got {t}")
    if not 1 <= n_cand <= t:
        raise ValueError(f"n_cand must be in [1, {t}], got {n_cand}")


def hamming_scores(query_codes: torch.Tensor,
                   item_codes: torch.Tensor) -> torch.Tensor:
    """(q, W) x (n, W) int32 codes on one CUDA device -> (q, n) int32
    Hamming distances. Raises on anything the kernel does not take."""
    w = check_codes(query_codes, item_codes)
    if w < 1 or w > _MAX_WORDS:
        raise ValueError(f"code width must be in [1, {_MAX_WORDS}] words, "
                         f"got {w}")
    nq, n = query_codes.shape[0], item_codes.shape[0]
    out = torch.empty((nq, n), dtype=torch.int32, device=query_codes.device)
    fn = _build.entry("hamming_scan", "hamming_scores_launch", 3, 3)
    err = fn(query_codes.data_ptr(), item_codes.data_ptr(), out.data_ptr(),
             nq, n, w, _build.stream_ptr(query_codes.device))
    _build.check(err, "hamming_scores")
    _build.count_launch("hamming_scores")
    return out


def hamming_nearest(ucodes: torch.Tensor, item_codes: torch.Tensor,
                    item_mask: torch.Tensor, n_cand: int) -> torch.Tensor:
    """ucodes (C, W) int32, item_codes (T, W) int32, item_mask (T,) bool on
    one CUDA device -> (C, n_cand) int32 tile rows: each lane's ``n_cand``
    rows of lowest Hamming distance, masked rows behind every live row, the
    lower row first on ties (``ref.hamming_nearest``). Raises on anything
    the kernel does not take."""
    check_selection(ucodes, item_codes, item_mask, n_cand)
    (c, w), t = ucodes.shape, item_codes.shape[0]
    cand = torch.empty((c, n_cand), dtype=torch.int32, device=ucodes.device)
    fn = _build.entry("hamming_scan", "hamming_nearest_launch", 4, 4)
    err = fn(ucodes.data_ptr(), item_codes.data_ptr(), item_mask.data_ptr(),
             cand.data_ptr(), c, t, w, n_cand,
             _build.stream_ptr(ucodes.device))
    _build.check(err, "hamming_nearest")
    _build.count_launch("hamming_nearest")
    return cand

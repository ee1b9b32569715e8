"""Wrapper of the CUDA inner-product top-k kernel (``csrc/ip_topk.cu``).

Port of ``src/repro/kernels/ip_topk.py:55-87`` (the Pallas
``ip_topk_tiles``). The kernel's note in its source says what bounds it on
an H100 and how it is laid out; this wrapper checks what it is given,
cuts the items into splits, allocates the outputs and launches on
PyTorch's current stream. The kernel reduces each split (a contiguous
range of whole ``BLOCK_N``-item tiles) to its top-k;
``ref.merge_topk`` merges the splits, as the reference's
``ops._merge_topk`` merges its tiles, and ``ref.ip_topk_partials`` is the
plain twin of the per-split output.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

BLOCK_Q = 128                   # queries per block (csrc/ip_topk.cu kBq)
BLOCK_N = 128                   # items per tile (csrc/ip_topk.cu kBn)
MAX_K = 128                     # the kernel's row lists (kMaxK)
_MAX_QUERIES = BLOCK_Q * 65535  # grid.y is limited to 65535 query tiles


def split_count(nq: int, n: int, slots: int) -> tuple[int, int]:
    """(splits, tiles per split) for nq queries and n items on a card that
    holds ``slots`` blocks at once: as many splits as let every query tile
    have one block in flight (at least 1, at most one tile each), evened
    out so that no split is empty. Split s covers item tiles
    [s * per, (s + 1) * per), the last one clipped to n."""
    q_tiles, n_tiles = -(-nq // BLOCK_Q), -(-n // BLOCK_N)
    want = max(1, min(n_tiles, slots // q_tiles))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def _slots(device: torch.device, k: int) -> int:
    """Blocks of the kernel the card holds at once for this k."""
    fn = _build.load("ip_topk").ip_topk_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    per_sm = fn(k)
    if per_sm <= 0:
        raise RuntimeError(f"ip_topk: the occupancy query failed with CUDA "
                           f"error {-per_sm}")
    return per_sm * torch.cuda.get_device_properties(
        device).multi_processor_count


def ip_topk_tiles(queries: torch.Tensor, items: torch.Tensor,
                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (q, d) f32, items (n, d) f32 on one CUDA device -> (vals,
    ids), each (q, splits, k): each split's k best inner products,
    descending, lower id first on ties, ids global rows, padded with
    (-inf, -1) where a split holds fewer than k items (``split_count``
    picks the splits). Raises on anything the kernel does not take."""
    for name, t in (("queries", queries), ("items", items)):
        _build.check_input(name, t, torch.float32, 2)
    if queries.device != items.device:
        raise ValueError("queries and items are on different devices")
    (nq, d), (n, d2) = queries.shape, items.shape
    if d != d2:
        raise ValueError(f"queries have {d} dims but items have {d2}")
    if not 1 <= k <= min(n, MAX_K):
        raise ValueError(f"k must be in [1, min(n, {MAX_K})], got {k}")
    if nq > _MAX_QUERIES:
        raise ValueError(f"at most {_MAX_QUERIES} queries per launch, "
                         f"got {nq}")
    splits, per = split_count(nq, n, _slots(queries.device, k))
    vals = torch.empty((nq, splits, k), dtype=torch.float32,
                       device=queries.device)
    ids = torch.empty((nq, splits, k), dtype=torch.int32,
                      device=queries.device)
    fn = _build.entry("ip_topk", "ip_topk_launch", 4, 6)
    err = fn(queries.data_ptr(), items.data_ptr(), vals.data_ptr(),
             ids.data_ptr(), nq, n, d, k, splits, per,
             _build.stream_ptr(queries.device))
    _build.check(err, "ip_topk")
    _build.count_launch("ip_topk")
    return vals, ids

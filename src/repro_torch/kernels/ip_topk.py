"""Wrapper of the CUDA per-tile inner-product top-k kernel
(``csrc/ip_topk.cu``).

Port of ``src/repro/kernels/ip_topk.py:55-87`` (the Pallas
``ip_topk_tiles``). The kernel's note in its source says what bounds it on
an H100 and how it is laid out; this wrapper checks what it is given,
allocates the outputs and launches on PyTorch's current stream. The merge
of the tiles lives in ``ops.ip_topk``, as the reference's lives in its
``ops._merge_topk``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

BLOCK_N = 128                   # items per tile (csrc/ip_topk.cu kBn)
_MAX_QUERIES = 32 * 65535       # grid.y is limited to 65535 tiles of 32 rows


def ip_topk_tiles(queries: torch.Tensor, items: torch.Tensor,
                  k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """queries (q, d) f32, items (n, d) f32 on one CUDA device -> (vals,
    ids), each (q, ceil(n / BLOCK_N), k): each item tile's k best inner
    products, descending, lower id first on ties, ids global rows. Raises
    on anything the kernel does not take."""
    for name, t in (("queries", queries), ("items", items)):
        _build.check_input(name, t, torch.float32, 2)
    if queries.device != items.device:
        raise ValueError("queries and items are on different devices")
    (nq, d), (n, d2) = queries.shape, items.shape
    if d != d2:
        raise ValueError(f"queries have {d} dims but items have {d2}")
    if not 1 <= k <= min(n, BLOCK_N):
        raise ValueError(f"k must be in [1, min(n, {BLOCK_N})], got {k}")
    if nq > _MAX_QUERIES:
        raise ValueError(f"at most {_MAX_QUERIES} queries per launch, "
                         f"got {nq}")
    n_tiles = -(-n // BLOCK_N)
    vals = torch.empty((nq, n_tiles, k), dtype=torch.float32,
                       device=queries.device)
    ids = torch.empty((nq, n_tiles, k), dtype=torch.int32,
                      device=queries.device)
    fn = _build.entry("ip_topk", "ip_topk_launch", 4, 4)
    err = fn(queries.data_ptr(), items.data_ptr(), vals.data_ptr(),
             ids.data_ptr(), nq, n, d, k, _build.stream_ptr(queries.device))
    _build.check(err, "ip_topk")
    _build.launch_counts["ip_topk"] += 1
    return vals, ids

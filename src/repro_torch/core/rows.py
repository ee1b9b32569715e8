"""Row products whose floats do not depend on how many rows share the call.

A matrix product's library kernel is picked by shape (cuBLAS picks its
tiling and split-K from m, n and k; the CPU's BLAS its blocking), so the
same row can round differently in a call over m rows and in one over
m / S. Tau, the Simpfer lower bounds, a delta buffer's inner products and
the cone bound's cosine feed strict decisions (``no_lb``, ``init_count``,
``ip > tau + eps``, Lemma 2), so one ulp can flip a prediction, and the
sharded engine must give the single-device bits (DESIGN.md SS11).

``by_rows`` therefore applies a row function to fixed-shape chunks of
``ROW_CHUNK`` rows, the last zero-padded: every call a product of the
same shape, whose row i depends only on row i and the shared operand,
whatever the row count, the shard or the row's position.
"""

from __future__ import annotations

from typing import Callable

import torch

ROW_CHUNK = 4096


def by_rows(fn: Callable[[torch.Tensor], torch.Tensor],
            rows: torch.Tensor) -> torch.Tensor:
    """``fn(rows)`` computed on (ROW_CHUNK, ...) chunks of ``rows``, the
    last one zero-padded, and concatenated: fn must map a chunk to one
    output row per input row."""
    m = rows.shape[0]
    outs = []
    for lo in range(0, max(m, 1), ROW_CHUNK):
        part = rows[lo:lo + ROW_CHUNK]
        n = part.shape[0]
        if n < ROW_CHUNK:
            part = torch.cat([part, part.new_zeros(
                (ROW_CHUNK - n,) + tuple(part.shape[1:]))])
        outs.append(fn(part)[:n])
    return torch.cat(outs)


def rows_matmul(rows: torch.Tensor, other: torch.Tensor) -> torch.Tensor:
    """``rows @ other`` by fixed-shape row chunks: (m, d) @ (d,) -> (m,)
    or (m, d) @ (d, c) -> (m, c)."""
    return by_rows(lambda part: part @ other, rows)

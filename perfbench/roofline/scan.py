"""Operations and bytes of the sketch tile scans, one function a path.

Counted from quantities that any implementation of the scan shares, so a
kernel that fuses the tile loop meets the same count: the chunks and
tile steps of the walk, the lanes a chunk holds and the configuration's
widths. Each input byte is counted once a tile step and each output byte
once; the work a step needs is what these inputs need, not what a
kernel reads again.

Reverse (``core/sa_alsh.py::decide_count``): a chunk of ``chunk`` user
lanes is hashed once (``srp_hash``: (chunk, d) x (d, n_bits)); each tile
step takes every lane's ``n_cand`` nearest rows of a ``tile``-row tile
by Hamming distance over W = n_bits / 32 words (an XOR and a popcount a
word) and re-ranks them by exact float32 inner products.

Forward (``core/sa_alsh.py::kmips_topk``): the batch of ``queries`` is
hashed once; each tile step does the same selection and re-rank for
every query, and merges into each query's running top-k.
"""

from __future__ import annotations

from perfbench.roofline.peaks import Work

F32 = 4
I32 = 4


def _hash(rows: int, d: int, n_bits: int) -> Work:
    words = n_bits // 32
    return Work(fp32=2.0 * rows * d * n_bits, int32=0.0,
                bytes=rows * d * F32 + d * n_bits * F32 + rows * words * I32)


def _tile_step(lanes: int, *, tile: int, n_bits: int, n_cand: int,
               d: int) -> Work:
    """One lane-set's pass over one tile: Hamming distances, selection
    and the re-rank. Inputs: the tile's codes, mask and rows, the lanes'
    codes and rows; output: the lanes' candidates' inner products."""
    words = n_bits // 32
    return Work(
        fp32=2.0 * lanes * n_cand * d,
        int32=2.0 * lanes * tile * words,
        bytes=(tile * words * I32 + tile + tile * d * F32
               + lanes * words * I32 + lanes * d * F32
               + lanes * n_cand * F32))


def reverse(*, chunks: int, tile_steps: int, chunk: int, tile: int,
            n_bits: int, n_cand: int, d: int) -> Work:
    """Work of the reverse execute's walk: ``chunks`` chunks of ``chunk``
    lanes and ``tile_steps`` tile steps over them all."""
    # each lane's threshold in, its decision out
    per_chunk = _hash(chunk, d, n_bits) + Work(0.0, 0.0, chunk * (F32 + 1))
    step = _tile_step(chunk, tile=tile, n_bits=n_bits, n_cand=n_cand, d=d)
    return per_chunk * chunks + step * tile_steps


def forward(*, batches: int, queries: int, tile_steps: int, tile: int,
            n_bits: int, n_cand: int, d: int, k: int) -> Work:
    """Work of ``batches`` forward batches of ``queries`` rows each, with
    ``tile_steps`` tile steps over them all: each batch's hash and its
    top-k written once, and the steps."""
    step = _tile_step(queries, tile=tile, n_bits=n_bits, n_cand=n_cand,
                      d=d)
    per_batch = _hash(queries, d, n_bits) + Work(
        0.0, 0.0, queries * k * (F32 + I32))
    return per_batch * batches + step * tile_steps

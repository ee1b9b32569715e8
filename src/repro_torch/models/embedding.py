"""EmbeddingBag of the recsys models: one concatenated table with per-field
row offsets.

Twin of ``src/repro/models/embedding.py`` on one device. All fields share
one (total_rows, dim) table; a field's ids become global rows by adding
its offset (``flatten_ids``), and a lookup is a plain gather
(``embedding_bag``), optionally times per-id weights (EmbeddingBag sum
weights). The reference's mod-row sharding over a 'model' mesh axis (its
``shard_map`` branch) goes with slice 16 of the port's multi-GPU work
(model parallelism): a policy that carries a mesh raises, through
``engine/sharding.py::check_policy``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist.policy import MODEL_SLICE
from repro_torch.engine.sharding import check_policy


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    vocab_sizes: tuple[int, ...]      # rows per field
    dim: int
    dtype: torch.dtype = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_rows(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]
                              ).astype(np.int32)


def init_table(generator: torch.Generator, cfg: EmbeddingConfig,
               pad_to: int = 1) -> torch.Tensor:
    """(total_rows padded to ``pad_to``, dim) table, N(0, 1/sqrt(dim)),
    drawn in float32 on the generator's device and cast to ``cfg.dtype``.
    Torch's draws, not JAX's: parity tests convert the reference's arrays
    instead."""
    rows = -(-cfg.total_rows // pad_to) * pad_to
    x = torch.randn(rows, cfg.dim, generator=generator,
                    device=generator.device, dtype=torch.float32)
    return x.mul_(cfg.dim ** -0.5).to(cfg.dtype)


def flatten_ids(ids: torch.Tensor, cfg: EmbeddingConfig) -> torch.Tensor:
    """Per-field ids (..., n_fields) -> global table rows (adds offsets)."""
    return ids + torch.as_tensor(cfg.offsets, dtype=ids.dtype,
                                 device=ids.device)


def embedding_bag(table: torch.Tensor, rows: torch.Tensor, policy=None,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Gather rows (any leading shape, integer global row ids) from the
    (R, D) table -> (..., D); ``weights`` (...,) multiplies each row."""
    check_policy(policy, "embedding_bag", MODEL_SLICE)
    out = torch.index_select(table, 0, rows.reshape(-1)).reshape(
        *rows.shape, table.shape[1])
    if weights is not None:
        out = out * weights[..., None]
    return out

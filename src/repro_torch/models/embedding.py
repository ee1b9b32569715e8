"""EmbeddingBag of the recsys models: one concatenated table with per-field
row offsets.

Twin of ``src/repro/models/embedding.py``. All fields share one
(total_rows, dim) table; a field's ids become global rows by adding its
offset (``flatten_ids``), and a lookup is a plain gather
(``embedding_bag``), optionally times per-id weights (EmbeddingBag sum
weights).

Under a mesh whose "model" axis has more than one rank the table is
row-sharded in contiguous blocks: the rank at "model" coordinate r holds
rows ``[r * R, (r + 1) * R)`` of the (padded) table, R = rows / tp
(``embedding.py:63-106``; ``shard_rows`` cuts it, ``init_table``'s
``pad_to`` makes the rows divide). A lookup is ``local_take`` (the rows
the rank holds, zeros elsewhere) and a sum over "model": one value plus
zeros, so the sharded lookup equals the whole table's bit for bit (but
for the sign of a zero). The rank looks up the rows it was given (the
reference splits the rows over the data axes when they divide; under
explicit SPMD a rank's rows are its own). The LM's vocabulary-sharded
``embed`` uses the same ``local_take``.

Every gather of rows that may repeat goes through ``gather_rows``: its
backward adds the gradients of a repeated row in float32 and rounds the
sum once, where autograd's own (``index_put_``/``index_add_``) adds them
in the table's dtype, which for bf16 loses a row that appears hundreds of
times in a batch (a frequent token).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.dist.policy import TP_AXIS_NAME


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


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, index, dim):
        ctx.save_for_backward(index)
        ctx.meta = (tuple(table.shape), table.dtype, dim)
        return torch.index_select(table, dim, index)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        shape, dtype, dim = ctx.meta
        acc = torch.zeros(shape, dtype=torch.promote_types(
            dtype, torch.float32), device=grad.device)
        acc.index_add_(dim, index, grad.to(acc.dtype))
        return acc.to(dtype), None, None


def gather_rows(table: torch.Tensor, index: torch.Tensor,
                dim: int = 0) -> torch.Tensor:
    """``torch.index_select(table, dim, index)`` (index 1-D), the same
    bits forward; backward, the gradients of each selected slice added
    into a float32 buffer and cast once to ``table``'s dtype (module
    docstring). Deterministic or not, the sum is float32: nondeterministic
    CUDA ``index_add_`` on a bf16 table adds in bf16."""
    if not (torch.is_grad_enabled() and table.requires_grad):
        return torch.index_select(table, dim, index)
    return _GatherRows.apply(table, index, dim)


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


def shard_rows(table: torch.Tensor, policy) -> torch.Tensor:
    """The rank's contiguous block of ``table``'s rows under ``policy``'s
    "model" axis (a copy; the table itself without a mesh). Raises when
    the rows do not divide (pad the table: ``init_table(pad_to=)``)."""
    if policy is None or policy.mesh is None:
        return table
    tp = policy.model_axis_size
    if table.shape[0] % tp:
        raise ValueError(f"a table of {table.shape[0]} rows does not shard "
                         f"over {tp} 'model' ranks: pad it to a multiple "
                         f"(init_table(pad_to=...), table_pad=)")
    return policy.relayout(table, (), (TP_AXIS_NAME,)).clone()


def local_take(table: torch.Tensor, rows: torch.Tensor, policy,
               axes=(TP_AXIS_NAME,)) -> torch.Tensor:
    """The rank's part of a row-sharded lookup: ``table`` is the rank's
    block of rows of a table tiled over ``axes``; rows (any leading
    shape) of global ids -> (..., D) with the rows the rank holds and
    zeros elsewhere (summed over ``axes``, the whole lookup)."""
    r_local = table.shape[0]
    lid = rows - policy.axis_index(axes) * r_local
    valid = (lid >= 0) & (lid < r_local)
    emb = gather_rows(table, torch.clamp(lid, 0, r_local - 1).reshape(-1)).reshape(*rows.shape,
                                                   table.shape[1])
    return torch.where(valid[..., None], emb, 0.0)


def embedding_bag(table: torch.Tensor, rows: torch.Tensor, policy=None,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Gather rows (any leading shape, integer global row ids) from the
    (R, D) table -> (..., D); ``weights`` (...,) multiplies each row.
    Under a mesh with a "model" axis of more than one rank ``table`` is
    the rank's block of rows (``shard_rows``) and the lookup a masked
    local take summed over "model" (module docstring)."""
    from repro_torch.dist import collectives as coll
    meshed = policy is not None and policy.mesh is not None
    if meshed:
        coll.check_mesh(policy)
    if meshed and policy.model_axis_size > 1:
        out = coll.psum(local_take(table, rows, policy), policy,
                        TP_AXIS_NAME)
    else:
        out = gather_rows(table, rows.reshape(-1)).reshape(
            *rows.shape, table.shape[1])
    if weights is not None:
        out = out * weights[..., None]
    return out

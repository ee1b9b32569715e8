"""Accuracy metrics for RkMIPS and kMIPS results (port of
``src/repro/core/metrics.py``)."""

from __future__ import annotations

import torch


def f1_score(pred: torch.Tensor, truth: torch.Tensor,
             mask: torch.Tensor | None = None) -> torch.Tensor:
    """F1 of boolean membership predictions against boolean truth, per
    leading batch element (..., m) -> (...). Empty truth and empty
    prediction count as 1."""
    if mask is not None:
        pred, truth = pred & mask, truth & mask
    tp = (pred & truth).sum(dim=-1).to(torch.float32)
    np_ = pred.sum(dim=-1).to(torch.float32)
    nt = truth.sum(dim=-1).to(torch.float32)
    precision = torch.where(np_ > 0, tp / torch.clamp(np_, min=1.0), 1.0)
    recall = torch.where(nt > 0, tp / torch.clamp(nt, min=1.0), 1.0)
    denom = precision + recall
    f1 = torch.where(denom > 0, 2 * precision * recall
                     / torch.clamp(denom, min=1e-9), 0.0)
    return torch.where((np_ == 0) & (nt == 0), 1.0, f1)


def recall(pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
    """Share of true members predicted, per row (1 for an empty truth)."""
    tp = (pred & truth).sum(dim=-1).to(torch.float32)
    nt = truth.sum(dim=-1).to(torch.float32)
    return torch.where(nt > 0, tp / torch.clamp(nt, min=1.0), 1.0)


def recall_at_k(pred_idx: torch.Tensor, true_idx: torch.Tensor
                ) -> torch.Tensor:
    """Set recall of predicted top-k ids against the true top-k ids, per
    row: (..., k) and (..., k) -> (...,) float32 in [0, 1]. The hit count
    is multiplied by the float32 reciprocal of k, as the reference's mean
    is computed, so the two agree bit for bit (9 * (1/10) is not 9 / 10
    in float32)."""
    hits = (pred_idx[..., :, None] == true_idx[..., None, :]).any(dim=-1)
    k = hits.shape[-1]
    return hits.to(torch.float32).sum(dim=-1) * torch.tensor(
        1.0 / k, dtype=torch.float32)

"""Accuracy metrics for RkMIPS results (port of
``src/repro/core/metrics.py:8-29``)."""

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

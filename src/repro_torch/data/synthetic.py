"""Synthetic recommendation datasets (port of
``src/repro/data/synthetic.py:19-81``).

Non-negative low-rank factor products, which reproduce what the
algorithms exploit: concentrated positive inner products and a
long-tailed item-norm distribution. Draws come from a CPU
``torch.Generator``: the same distribution as the reference, not the same
bits (torch cannot replay ``jax.random``). Results land on ``device``,
which the caller names.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class PaperDataset:
    name: str
    n_items: int
    m_users: int
    d: int = 100


PAPER_DATASETS = {
    "amazon-auto": PaperDataset("amazon-auto", 925387, 3873247),
    "amazon-cds": PaperDataset("amazon-cds", 64443, 75258),
    "movielens": PaperDataset("movielens", 10681, 71567),
    "music100": PaperDataset("music100", 1000000, 1000000),
    "netflix": PaperDataset("netflix", 17770, 480189),
}


def _randn(generator: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randn(*shape, generator=generator, dtype=torch.float32)


def mf_factors(generator: torch.Generator, n: int, d: int, rank: int = 16,
               kind: str = "nmf", h: torch.Tensor | None = None,
               noise: float = 1.0, skew: float = 0.1, *,
               device) -> torch.Tensor:
    """Rows of a factor matrix with MF-like low-rank structure (rank 16,
    noise 1.0, skew 0.1: the reference's calibration)."""
    if kind == "nmf":
        w = _randn(generator, n, rank).abs()
        if h is None:
            h = _randn(generator, rank, d).abs()
        x = w @ h.cpu() / rank + noise * _randn(generator, n, d).abs()
        scale = torch.exp(skew * _randn(generator, n, 1))
        return (x * scale).to(device)
    if kind == "gaussian":
        return _randn(generator, n, d).to(device)
    raise ValueError(kind)


def recommendation_data(generator: torch.Generator, n_items: int,
                        m_users: int, d: int, rank: int = 16,
                        kind: str = "nmf", *, device):
    """(items (n, d), users (m, d)) sharing the item-factor structure."""
    h = _randn(generator, rank, d).abs() if kind == "nmf" else None
    items = mf_factors(generator, n_items, d, rank, kind, h=h, device=device)
    users = mf_factors(generator, m_users, d, rank, kind, h=h, device=device)
    return items, users


def queries_from_items(generator: torch.Generator, items: torch.Tensor,
                       nq: int, top_frac: float = 0.2) -> torch.Tensor:
    """Queries drawn without replacement from the top ``top_frac`` of the
    items by norm (the paper draws queries from the item matrix)."""
    order = torch.argsort(-torch.linalg.norm(items, dim=-1), stable=True)
    hi = max(nq, int(items.shape[0] * top_frac))
    pick = torch.randperm(hi, generator=generator)[:nq]
    return items[order[pick.to(items.device)]]

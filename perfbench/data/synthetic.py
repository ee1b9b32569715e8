"""The benchmark's frozen copy of the synthetic recommendation data.

Copied from ``src/repro_torch/data/synthetic.py`` at commit
d661408c4aff9ee95f174176b18a29a680cbdd15 (``mf_factors``,
``recommendation_data``, ``_low_rank``), so that a later change to the
program's generator cannot move the yardstick. One change: every draw
and the float64 low-rank product happen on the generator's own device,
so the benchmark makes a full-size dataset on the card in a few large
calls instead of on the host. The product stays exact (float64 products
of float32 factors, summed over the rank in a fixed order), so one seed
gives one dataset on every card of one kind; a CPU generator gives the
CPU's draws, which ``test_perfbench_data.py`` pins.

Non-negative rank-16 factor products plus |noise| 1.0 and a log-normal
norm skew 0.1: concentrated positive inner products and a long-tailed
item-norm distribution, the calibration of the reference package.
"""

from __future__ import annotations

import torch


def _randn(generator: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randn(*shape, generator=generator, dtype=torch.float32,
                       device=generator.device)


def _low_rank(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """``w @ h`` formed in float64, summed over the rank in a fixed
    order, then cast to float32."""
    w64, h64 = w.double(), h.double()
    x = torch.zeros(w.shape[0], h.shape[1], dtype=torch.float64,
                    device=w.device)
    for r in range(w.shape[1]):
        x.addcmul_(w64[:, r:r + 1], h64[r])
    return x.float()


def mf_factors(generator: torch.Generator, n: int, d: int, h: torch.Tensor,
               rank: int = 16, noise: float = 1.0,
               skew: float = 0.1) -> torch.Tensor:
    """(n, d) rows with MF-like low-rank structure over the shared
    ``h`` (rank, d)."""
    w = _randn(generator, n, rank).abs()
    x = _low_rank(w, h) / rank + noise * _randn(generator, n, d).abs()
    scale = torch.exp(skew * _randn(generator, n, 1))
    return x * scale


def recommendation_data(generator: torch.Generator, n_items: int,
                        m_users: int, d: int, rank: int = 16):
    """(items (n, d), users (m, d)) float32 on the generator's device,
    sharing the item-factor structure."""
    h = _randn(generator, rank, d).abs()
    items = mf_factors(generator, n_items, d, h, rank)
    users = mf_factors(generator, m_users, d, h, rank)
    return items, users

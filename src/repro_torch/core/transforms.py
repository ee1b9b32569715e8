"""Asymmetric MIPS -> NNS transforms (port of ``src/repro/core/transforms.py``).

SAT (the paper's Eq. 6-7) maps an item p of a partition with centroid c
and radius R to I(p, c) = [p - c ; sqrt(R^2 - ||p - c||^2)] and a user to
U(u) = [lambda u ; 0], both on the radius-R sphere, so MIPS over a shifted
partition becomes angular NNS. QNF (H2-ALSH) is the unshifted
I(p) = [p ; sqrt(M^2 - ||p||^2)]. A user's appended coordinate is 0, so
its SRP code needs only the first d rows of the projection.

Only ``sat_item_transform`` has a caller in the port
(``sa_alsh.prepare_items``). The other three are kept for parity with the
reference's module and are tested against it; the QNF branch of
``prepare_items`` stays inline because the reference's build forms it
that way.
"""

from __future__ import annotations

import torch


def sat_item_transform(items: torch.Tensor, centroid: torch.Tensor,
                       radius: torch.Tensor) -> torch.Tensor:
    """SAT item transform: items (n, d), centroid (d,) or per row (n, d),
    radius a scalar or per row (n,) -> (n, d+1). The appended coordinate
    is sqrt(max(R^2 - ||p - c||^2, 0))."""
    shifted = items - centroid
    sq = torch.clamp(radius ** 2 - torch.sum(shifted * shifted, dim=-1),
                     min=0.0)
    return torch.cat([shifted, torch.sqrt(sq)[:, None]], dim=-1)


def qnf_item_transform(items: torch.Tensor,
                       max_norm: torch.Tensor) -> torch.Tensor:
    """QNF item transform of H2-ALSH: items (n, d), max_norm a scalar ->
    (n, d+1)."""
    sq = torch.clamp(max_norm ** 2 - torch.sum(items * items, dim=-1),
                     min=0.0)
    return torch.cat([items, torch.sqrt(sq)[:, None]], dim=-1)


def user_transform(users: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """U(u) = [scale * u ; 0]: users (m, d) -> (m, d+1)."""
    zeros = torch.zeros(users.shape[:-1] + (1,), dtype=users.dtype,
                        device=users.device)
    return torch.cat([users * scale[..., None], zeros], dim=-1)


def centroid_and_radius(items: torch.Tensor,
                        mask: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Centroid c = mean(items) and radius R = max ||p - c|| (over the
    rows ``mask`` keeps, when given)."""
    if mask is None:
        c = items.mean(dim=0)
        return c, torch.sqrt(torch.sum((items - c) ** 2, dim=-1).max())
    w = mask.to(items.dtype)
    c = (items * w[:, None]).sum(dim=0) / torch.clamp(w.sum(), min=1.0)
    d2 = torch.sum((items - c) ** 2, dim=-1)
    return c, torch.sqrt(torch.where(mask, d2, 0.0).max())

"""Simpfer-style lower bounds (Amagata & Hara 2021), used by SAH.

Port of ``src/repro/core/simpfer.py:29-75``. For each unit user u,
L_u[j] is the (j+1)-th largest <u, p> over the top-norm items P';
L_B[j] = min over a leaf's users. Decisions (strict-count convention):
"no" if L_u[k-1] > tau + eps; init_count = #{j : L_u[j] > tau + eps} is
exact whenever the "no" rule did not fire; "yes" if tau >= ||p_k||.
"""

from __future__ import annotations

import torch

from repro_torch.core.rows import rows_matmul


def user_lower_bounds(users_unit: torch.Tensor, top_items: torch.Tensor,
                      kmax: int, *, mask: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """L (m, kmax) descending: the top-kmax IPs of each user over P'.
    ``mask`` (n_top,) retires P' members (their IPs become -inf). A float32
    GEMM by fixed-shape row chunks (``core/rows.py``), so a user's bounds
    are the same bits whatever slice of the users the call is given (a
    shard's, in the mesh build and ``row_parallel``)."""
    ips = rows_matmul(users_unit, top_items.T)
    if mask is not None:
        ips = torch.where(mask[None, :], ips, float("-inf"))
    return torch.topk(ips, kmax, dim=-1, sorted=True).values


def block_lower_bounds(user_lb_perm: torch.Tensor, n_blocks: int
                       ) -> torch.Tensor:
    """L_B (n_blocks, kmax) = min over each leaf's users (perm order)."""
    m_pad, kmax = user_lb_perm.shape
    return user_lb_perm.reshape(n_blocks, -1, kmax).amin(dim=1)


def init_count(user_lb: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """#{j : L_u[j] > tau} per user: (..., kmax), (...) -> int32."""
    return (user_lb > tau[..., None]).sum(dim=-1).to(torch.int32)

"""Cone blocking of user vectors (the paper's Cone-Tree, Algorithm 3).

Port of ``src/repro/core/cone.py:57-173``. Users are unit vectors; the
tree is split level by level into balanced halves (median of
<u, u_l> - <u, u_r>), so every leaf holds ``leaf_size`` users and leaves
are contiguous runs of one permutation. Each leaf keeps a center, its max
angle omega and every user's angle theta, from which Lemma 2 (per block)
and Lemma 3 (per user) bound <u, q>.

The only random input is the initial permutation (``cone.py:76``). Torch
cannot replay ``jax.random``, so ``_build`` takes it as an argument.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.rows import by_rows


class ConeBlocks(NamedTuple):
    """Flat cone-leaf structure. n_blocks * leaf_size == m_pad.

    perm (m_pad,) int32 user rows (of the padded array) in leaf order;
    center (n_blocks, d) f32; omega (n_blocks,) f32; theta (m_pad,) f32
    in perm order.
    """

    perm: torch.Tensor
    center: torch.Tensor
    omega: torch.Tensor
    theta: torch.Tensor

    @property
    def n_blocks(self) -> int:
        return self.center.shape[0]

    @property
    def leaf_size(self) -> int:
        return self.perm.shape[0] // self.center.shape[0]


def padded_size(m: int, leaf_size: int) -> tuple[int, int]:
    """(m_pad, n_leaves): a power-of-two number of leaves covering m."""
    n_leaves = max(1, 2 ** math.ceil(math.log2(max(m / leaf_size, 1))))
    m_pad = n_leaves * leaf_size
    if m_pad < m:
        n_leaves *= 2
        m_pad = n_leaves * leaf_size
    return m_pad, n_leaves


def pad_users(users_unit: torch.Tensor, leaf_size: int
              ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Pad m users to m_pad = n_leaves * leaf_size by cyclic repetition.
    Returns (padded (m_pad, d), mask (m_pad,) of real rows, n_leaves)."""
    m = users_unit.shape[0]
    m_pad, n_leaves = padded_size(m, leaf_size)
    reps = -(-m_pad // m)
    padded = users_unit.repeat(reps, 1)[:m_pad]
    mask = torch.arange(m_pad, device=users_unit.device) < m
    return padded, mask, n_leaves


def angle(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The angle between each row of x (..., n, d) and c (..., d) as
    ``atan2(|x - (x.c^)c^|, x.c^)``: accurate to float32 rounding at every
    angle, where ``arccos`` of a float32 cosine resolves only ~3.45e-4 rad
    near 0 (one ulp of the cosine), more than Lemma 3's slack covers at
    low d (PORT.md, "The cone bounds")."""
    c_hat = c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True),
                            min=1e-12)
    par = torch.einsum("...nd,...d->...n", x, c_hat)
    orth = torch.linalg.norm(x - par[..., None] * c_hat[..., None, :],
                             dim=-1)
    return torch.atan2(orth, par)


def _leaf_stats(xl: torch.Tensor):
    """center, omega, theta of leaves xl (n_blocks, leaf, d)."""
    center = xl.mean(dim=1)
    theta = angle(xl, center)
    return center, theta.amax(dim=-1), theta.reshape(-1)


def _build(users: torch.Tensor, order: torch.Tensor, *, n_blocks: int,
           n_levels: int) -> ConeBlocks:
    """Balanced cone tree over padded unit users from initial permutation
    ``order`` (m_pad,). Ties in every sort keep the earlier position."""
    m_pad, d = users.shape
    order = order.to(device=users.device, dtype=torch.int64)
    for level in range(n_levels):
        blocks = 1 << level
        size = m_pad // blocks
        x = users[order].reshape(blocks, size, d)
        v = x[:, 0, :]                        # random pivot: order is shuffled
        ip_v = torch.einsum("bsd,bd->bs", x, v)
        pick = torch.argmin(ip_v, dim=-1)
        u_l = x[torch.arange(blocks, device=x.device), pick]
        ip_l = torch.einsum("bsd,bd->bs", x, u_l)
        pick = torch.argmin(ip_l, dim=-1)
        u_r = x[torch.arange(blocks, device=x.device), pick]
        ip_r = torch.einsum("bsd,bd->bs", x, u_r)
        split_key = ip_l - ip_r
        sorted_idx = torch.argsort(-split_key, dim=-1, stable=True)
        order = torch.gather(order.reshape(blocks, size), 1,
                             sorted_idx).reshape(-1)

    leaf = m_pad // n_blocks
    center, omega, theta = _leaf_stats(users[order].reshape(n_blocks, leaf, d))
    return ConeBlocks(perm=order.to(torch.int32), center=center, omega=omega,
                      theta=theta)


def build_cone_blocks(users_unit: torch.Tensor, order: torch.Tensor,
                      leaf_size: int = 32
                      ) -> tuple[ConeBlocks, torch.Tensor, torch.Tensor]:
    """Build cone blocks from the initial permutation ``order`` of the
    padded rows. Returns (blocks, padded_users (m_pad, d), user_mask)."""
    padded, mask, n_leaves = pad_users(users_unit, leaf_size)
    if tuple(order.shape) != (padded.shape[0],):
        raise ValueError(f"cone order must be a permutation of the "
                         f"{padded.shape[0]} padded users, got shape "
                         f"{tuple(order.shape)}")
    n_levels = int(math.log2(n_leaves))
    blocks = _build(padded, order, n_blocks=n_leaves, n_levels=n_levels)
    return blocks, padded, mask


def norm_blocks(users_unit: torch.Tensor, leaf_size: int = 32
                ) -> tuple[ConeBlocks, torch.Tensor, torch.Tensor]:
    """Simpfer-style blocking: contiguous ``leaf_size`` runs in input
    order, with honest cone statistics (same return contract as
    ``build_cone_blocks``, ``perm`` the identity)."""
    padded, mask, n_leaves = pad_users(users_unit, leaf_size)
    perm = torch.arange(padded.shape[0], dtype=torch.int32,
                        device=padded.device)
    center, omega, theta = _leaf_stats(
        padded.reshape(n_leaves, leaf_size, -1))
    return ConeBlocks(perm=perm, center=center, omega=omega,
                      theta=theta), padded, mask


def node_upper_bound(q: torch.Tensor, blocks: ConeBlocks
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Lemma 2: max_{u in B} <u, q> <= ||q|| cos({phi - omega}_+).
    q (d,) -> (bound (n_blocks,), phi (n_blocks,)). The cosine is taken
    by fixed-shape row chunks (``core/rows.py``), so a block's bound has
    the same bits in a shard's slice of the blocks as in all of them."""
    qn = torch.linalg.norm(q)
    phi = by_rows(lambda center: angle(center[:, None, :], q)[:, 0],
                  blocks.center)
    return qn * torch.cos(torch.clamp(phi - blocks.omega, min=0.0)), phi


def vector_upper_bound(qn: torch.Tensor, phi: torch.Tensor,
                       blocks: ConeBlocks) -> torch.Tensor:
    """Lemma 3: <u, q> <= ||q|| cos(|phi - theta_u|), per user (perm
    order). phi (n_blocks,) from ``node_upper_bound`` -> (m_pad,)."""
    phi_u = torch.repeat_interleave(phi, blocks.leaf_size)
    return qn * torch.cos(torch.abs(phi_u - blocks.theta))

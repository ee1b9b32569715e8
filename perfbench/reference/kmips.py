"""Plain PyTorch reference for reverse and forward k-MIPS.

Imports nothing of the program. It works from the raw items, users and
queries the harness made, never from the program's index, codes or
oracle, and computes in float32 with TF32 off (float64 where it judges a
tie or a returned value).

The reverse convention is the one ``src/repro_torch/core/exact.py``
states, re-implemented: users are taken as unit rows, and q is in the
top-k of user u over the items P (q among them) iff
``#{p in P : <u, p> > <u, q> + tie_eps * ||q||} <= k - 1``. That count is
below k exactly when the k-th largest ``<u, p>`` is at most the
threshold, so one pass over the items gives every user's k-th largest
value and every query after it costs one product with the users.

``tf32`` rounds a float32 tensor to TF32's 10 mantissa bits (to nearest,
ties away, as the tensor cores' conversion does): the control puts this
reference, so rounded, in the program's place.
"""

from __future__ import annotations

import torch

# Elements of one (users, items) block of the k-th value pass.
BLOCK_ELEMENTS = 1 << 28


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa
    bits), kept in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def kth_values(items: torch.Tensor, users_unit: torch.Tensor,
               k: int) -> torch.Tensor:
    """(m,) the k-th largest ``<u, p>`` over all items, per user, in
    blocks of users so that one block's products fit."""
    no_tf32()
    n = items.shape[0]
    block = max(1, BLOCK_ELEMENTS // n)
    out = torch.empty(users_unit.shape[0], dtype=torch.float32,
                      device=users_unit.device)
    for lo in range(0, users_unit.shape[0], block):
        ips = users_unit[lo:lo + block] @ items.T
        out[lo:lo + block] = torch.topk(ips, k, dim=-1).values[:, -1]
        del ips
    return out


def reverse_answers(kth: torch.Tensor, users_unit: torch.Tensor,
                    queries: torch.Tensor, tie_eps: float) -> torch.Tensor:
    """bool (nq, m): q is in user u's top-k (``kth`` from
    ``kth_values``)."""
    no_tf32()
    thr = queries @ users_unit.T + (
        tie_eps * torch.linalg.norm(queries, dim=-1))[:, None]
    return kth[None, :] <= thr


def tied(items: torch.Tensor, users_unit: torch.Tensor,
         queries: torch.Tensor, k: int, tie_eps: float) -> torch.Tensor:
    """bool (P,): whether each (user, query) pair's decision lies within
    float32 rounding of its threshold, recomputed in float64 (users_unit
    and queries are (P, d), one row a pair). Two correct float32
    evaluations may disagree on such a pair and on no other.

    The radius ``8 * d * 2**-24 * ||u|| * (max ||p|| + ||q||)`` bounds the
    float32 error of one dot product, doubled for the threshold's; the
    decision is tied iff it differs between the counts of items beating
    the threshold by more than the radius and by more than minus it."""
    it = items.double()
    pmax = float(torch.linalg.norm(it, dim=-1).max())
    d = items.shape[1]
    out = torch.empty(users_unit.shape[0], dtype=torch.bool,
                      device=users_unit.device)
    block = max(1, BLOCK_ELEMENTS // 4 // items.shape[0])
    for lo in range(0, users_unit.shape[0], block):
        u = users_unit[lo:lo + block].double()
        q = queries[lo:lo + block].double()
        qn = torch.linalg.norm(q, dim=-1)
        tol = 8 * d * 2.0 ** -24 * torch.linalg.norm(u, dim=-1) * (pmax + qn)
        thr = (u * q).sum(-1) + tie_eps * qn
        ips = u @ it.T
        lo_cnt = (ips > (thr + tol)[:, None]).sum(-1)
        hi_cnt = (ips > (thr - tol)[:, None]).sum(-1)
        out[lo:lo + block] = (lo_cnt <= k - 1) != (hi_cnt <= k - 1)
    return out


def topk(items: torch.Tensor, queries: torch.Tensor, k: int):
    """Exact forward top-k: (values, int64 ids), each (Q, k), values
    descending."""
    no_tf32()
    return torch.topk(queries @ items.T, k, dim=-1)


def pair_values(items: torch.Tensor, queries: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """float64 ``<q, p_id>`` for each (query, slot): ids (Q, k) int."""
    rows = items.double()[ids.long()]
    return (rows * queries.double()[:, None, :]).sum(-1)

"""Exact (brute-force) kMIPS and RkMIPS oracles, and the float-tie test
their comparisons need.

Port of ``src/repro/core/exact.py``. Convention shared by every method:
q is in the kMIPS result of u over P u {q} iff
#{p in P : <u, p> > <u, q> + tie_eps * ||q||} <= k - 1.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref

# Elements of (nq, users, items) compared per step of the chunked oracle.
_ORACLE_BLOCK = 1 << 27


def kmips(items: torch.Tensor, queries: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k MIPS: items (n, d), queries (q, d) -> (values, int64
    indices), each (q, k), the lower index first among equal values (as
    ``lax.top_k`` breaks ties). One product and a stable top-k: the
    reference's oracle, off the kernels as the reference's is off
    Pallas."""
    return _ref.topk_stable(queries @ items.T, k)


def rkmips_decision(items: torch.Tensor, users: torch.Tensor,
                    query: torch.Tensor, k: int,
                    tie_eps: float = 0.0) -> torch.Tensor:
    """Exact RkMIPS for one query -> bool (m,): q is in kMIPS_k(u, P u
    {q}). Items beat tau only when ip > tau + tie_eps * ||q|| (the strict
    rule at tie_eps = 0)."""
    eps = tie_eps * torch.linalg.norm(query)
    tau = users @ query
    beat = ((users @ items.T) > (tau + eps)[:, None]).sum(dim=-1)
    return beat <= k - 1


def rkmips_batch(items: torch.Tensor, users: torch.Tensor,
                 queries: torch.Tensor, k: int,
                 tie_eps: float = 0.0) -> torch.Tensor:
    """Exact RkMIPS for a batch of queries -> bool (nq, m)."""
    eps = tie_eps * torch.linalg.norm(queries, dim=-1)
    tau = queries @ users.T
    ips = users @ items.T
    beat = (ips[None, :, :] > (tau + eps[:, None])[:, :, None]).sum(dim=-1)
    return beat <= k - 1


def rkmips_batch_chunked(items: torch.Tensor, users: torch.Tensor,
                         queries: torch.Tensor, k: int,
                         tie_eps: float = 0.0) -> torch.Tensor:
    """Memory-bounded exact RkMIPS: users are taken in chunks so that
    nq * chunk * n stays under 2**27 compared elements."""
    nq, n = queries.shape[0], items.shape[0]
    chunk = max(1, _ORACLE_BLOCK // max(1, nq * n))
    return torch.cat([rkmips_batch(items, users[lo:lo + chunk], queries, k,
                                   tie_eps)
                      for lo in range(0, users.shape[0], chunk)], dim=1)


def float_tie(items: torch.Tensor, user: torch.Tensor, query: torch.Tensor,
              k: int, tie_eps: float = 0.0) -> bool:
    """Whether one (user, query) decision lies within float32 rounding of
    its threshold, so that two correct float32 evaluations may disagree.

    Recomputed in float64: ``lo``/``hi`` count the items whose inner
    product beats tau + eps by more than / by at least minus the
    rounding radius ``8 * d * 2**-24 * ||u|| * (max ||p|| + ||q||)`` (the
    float32 error of one dot product, doubled for tau's). The decision
    ``count <= k - 1`` is tied iff it differs between the two counts.
    """
    items, user, query = (t.double() for t in (items, user, query))
    d = items.shape[1]
    tol = (8 * d * 2.0 ** -24 * float(torch.linalg.norm(user))
           * (float(torch.linalg.norm(items, dim=-1).max())
              + float(torch.linalg.norm(query))))
    thr = float(user @ query) + tie_eps * float(torch.linalg.norm(query))
    ips = items @ user
    lo = int((ips > thr + tol).sum())
    hi = int((ips > thr - tol).sum())
    return (lo <= k - 1) != (hi <= k - 1)

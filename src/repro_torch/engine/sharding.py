"""The single-device flat kMIPS scan of the serving stack (port of the
``mesh=None`` branch of ``src/repro/engine/sharding.py:112-342``).

``kmips_flat_arrays`` answers a micro-batch of queries over a whole row
slab in one pass: under ``scan="sketch"`` one launch of the dense
``hamming_scores`` kernel gives the (Q, N) Hamming distances of the batch,
masked rows get ``BIG_HAMMING``, each query keeps its ``n_c`` nearest rows
(``ref.nearest_rows``: the lower row first on ties, the order of the
reference's ``lax.top_k(-dist)``) and re-ranks them exactly; under
``scan="exact"`` every row is scored, one ``torch.mv`` per query.

Each query's floats are computed by an expression whose result for a row
does not depend on how many rows share the call (``sa_alsh.lane_ips``, a
per-pair product and row sum, and one matrix-vector product per query), so
a bucket-padded dispatch answers bitwise as the full batch does
(DESIGN.md §14). The reference keeps the same contract by mapping its
float work over queries (``lax.map``); the integer distances and the
integer selection do not depend on Q, so the port runs them once per
dispatch.

Meshes go with the multi-GPU slice of the port: a policy that carries a
mesh raises (``check_policy``).
"""

from __future__ import annotations

import torch

from repro_torch.core import sa_alsh as _alsh
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


def check_policy(policy, who: str) -> None:
    """Raise ``NotImplementedError`` unless ``policy`` is single-device:
    None, or an object whose ``mesh`` is None."""
    if policy is not None and getattr(policy, "mesh", policy) is not None:
        raise NotImplementedError(
            f"{who}: sharding over a device mesh is not ported yet (the "
            f"multi-GPU slice of the port); pass policy=None")


def pad_item_rows(items: torch.Tensor, item_ids: torch.Tensor,
                  item_mask: torch.Tensor, codes: torch.Tensor,
                  shards: int, k: int = 1):
    """Pad the item-axis arrays so that ``shards`` shards each hold at
    least ``k`` rows and the rows divide evenly (``sharding.py:112``).
    Padding rows are dead: zero vectors, id -1, mask False, zero codes.
    Returns the inputs themselves when nothing needs padding.

    No path of the port calls it yet: in the reference only the mesh
    branch does, so it is kept for parity until the multi-GPU slice
    brings that branch and its caller."""
    n = items.shape[0]
    rows_per = max(-(-n // shards), k)
    pad = rows_per * shards - n
    if pad == 0:
        return items, item_ids, item_mask, codes

    def tail(x, fill):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=x.device)])

    return (tail(items, 0), tail(item_ids, -1), tail(item_mask, False),
            tail(codes, 0))


def _flat_candidates(items, item_ids, item_mask, codes, ucodes, queries,
                     k: int, n_cand: int, scan: str):
    """One pass over a row slab (``sharding.py:249-285``): the sketch
    (Hamming top-``n_cand`` by one dense kernel launch, then an exact
    re-rank) or the exact scan, then the top k. Returns (vals (Q, k),
    ids (Q, k) original item rows)."""
    neg = float("-inf")
    if scan == "exact":
        ips = torch.stack([torch.where(item_mask, torch.mv(items, q), neg)
                           for q in queries])
        vals, pos = kref.topk_stable(ips, k)
        return vals, item_ids[pos]
    dist = kops.hamming_scores(ucodes, codes)                   # (Q, N)
    dist = torch.where(item_mask[None, :], dist, kref.BIG_HAMMING)
    cand = kref.nearest_rows(dist, n_cand).long()               # (Q, n_c)
    ips = torch.where(item_mask[cand], _alsh.lane_ips(items, cand, queries),
                      neg)
    vals, pos = kref.topk_stable(ips, k)
    return vals, item_ids[cand.gather(1, pos)]


def kmips_flat_arrays(items: torch.Tensor, item_ids: torch.Tensor,
                      item_mask: torch.Tensor, codes: torch.Tensor,
                      ucodes: torch.Tensor | None, queries: torch.Tensor,
                      k: int, policy=None, *, n_cand: int = 64,
                      scan: str = "sketch"):
    """Single-pass kMIPS over raw row arrays, the serving stack's scan
    (``sharding.py:288-323``). items (N, d) f32, item_ids (N,) int32
    (-1 padding), item_mask (N,) bool, codes (N, W) int32, ucodes (Q, W)
    int32 query codes (None under ``scan="exact"``), queries (Q, d) ->
    (vals (Q, k) descending, ids (Q, k)). ``n_cand`` is raised to k and
    capped at N. A query's answer does not depend on the rest of the
    batch (module docstring)."""
    check_policy(policy, "kmips_flat_arrays")
    n_c = min(max(n_cand, k), items.shape[0])
    return _flat_candidates(items, item_ids, item_mask, codes, ucodes,
                            queries, k, n_c, scan)


def kmips_flat(index: _alsh.SAALSHIndex, queries: torch.Tensor, k: int,
               policy=None, *, n_cand: int = 64, scan: str = "sketch"):
    """Single-pass kMIPS over a forward index (``sharding.py:326-342``):
    queries (Q, d) -> (vals (Q, k) descending, ids (Q, k) original item
    rows). ``n_cand`` at least the live row count makes the sketch exact.
    The engine's ``kmips`` takes the tiled, early-terminating
    ``sa_alsh.kmips_topk`` instead."""
    ucodes = _alsh.user_codes(index, queries) if scan == "sketch" else None
    return kmips_flat_arrays(index.items, index.item_ids, index.item_mask,
                             index.codes, ucodes, queries, k, policy,
                             n_cand=n_cand, scan=scan)

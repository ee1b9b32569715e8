"""Mesh-sharded execution paths of the RkMIPS engine and the flat kMIPS
scan of the serving stack (port of ``src/repro/engine/sharding.py``,
DESIGN.md SS7-SS8).

Both heavy loops shard along one axis, one process per rank (SPMD):

  * RkMIPS is independent **per user**. The user side of the ``SAHIndex``
    (leaf-ordered users, angles, lower bounds, cone blocks:
    ``_USER_AXIS_FIELDS``, ``_BLOCK_AXIS_FIELDS``) is row-sharded over
    every mesh axis, the item side (SA-ALSH index, top-norm prefix) and a
    staged delta buffer are replicated. Each rank runs the port's batched
    plan/execute (``core/sah.py::rkmips_batch``) on its shard
    (``shard_index``) for the whole query batch; one all-gather along the
    user axis, in mesh order, reassembles the (nq, m_pad) predictions and
    one all-reduce sums the counters. A scan budget caps each shard's own
    tile count and ``truncated`` is summed.
  * kMIPS shards along **items**: each rank Hamming-scans its slice of
    the rows, re-ranks its own top-``n_cand`` exactly, keeps a local
    top-k, and one all-gather and a stable top-k merge the winners (ties
    to the lower shard, then the lower local rank: ``lax.top_k`` on the
    concatenation).

Any count shards over any mesh: cone blocks are padded to a multiple of
the rank count with dead leaves (cyclic duplicates whose ``user_mask`` is
False and whose block lower bound is +inf, so Lemma 2 kills them before
any work), item rows with dead rows (zero, id -1, masked). A user's or a
block's floats do not depend on the rows that share its call
(``core/rows.py``), so the predictions and the per-user counters equal the
single-device run bit for bit; ``tiles_scanned`` and ``chunks`` count each
shard's own packing and are summed.

Every rank makes each call with the same queries and k
(``dist.collectives.check_same_call`` holds it), and every rank gets the
whole answer (the reference's ``out_specs=P()``).

``kmips_flat_arrays`` on one device answers a micro-batch over a whole
row slab in one pass: under ``scan="sketch"`` one launch of the dense
``hamming_scores`` kernel gives the (Q, N) distances, masked rows get
``BIG_HAMMING``, each query keeps its ``n_c`` nearest rows
(``ref.nearest_rows``, the lower row first on ties) and re-ranks them
exactly; under ``scan="exact"`` every row is scored. Each query's floats
do not depend on Q (``sa_alsh.lane_ips``; one fixed-chunk product per
query), so a bucket-padded dispatch answers bitwise as the full batch
does (DESIGN.md SS14).
"""

from __future__ import annotations

import torch

from repro_torch.core import sa_alsh as _alsh
from repro_torch.core import sah as _sah
from repro_torch.core.rows import rows_matmul
from repro_torch.dist import collectives as _coll
from repro_torch.dist.policy import rank_device, shard_rank
from repro_torch.engine.artifact import device_of
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

# SAHIndex fields whose leading axis is the (padded, leaf-ordered) user
# axis or the cone-block axis; everything else is replicated.
_USER_AXIS_FIELDS = ("users", "user_ids", "user_mask", "theta", "user_lb")
_BLOCK_AXIS_FIELDS = ("center", "omega", "block_lb")


def policy_device(policy, device, who: str) -> torch.device:
    """Where ``who`` computes under ``policy``: ``device`` without a mesh
    (None means "cuda", ``artifact.device_of``); under a mesh the rank's
    own device (``rank_device``), which a given ``device`` must equal."""
    if policy is None or policy.mesh is None:
        return device_of(device, who)
    _coll.check_mesh(policy)
    dev = rank_device(policy)
    if device is not None and torch.device(device) != dev:
        raise ValueError(f"{who}: under a mesh it runs on the rank's "
                         f"device {dev}, not {torch.device(device)}")
    return dev


def _meshed(policy) -> bool:
    """Whether ``policy`` carries a mesh; a mesh that is not a
    ``DeviceMesh`` over the whole world raises."""
    if policy is None or policy.mesh is None:
        return False
    _coll.check_mesh(policy)
    return True


def n_shards(policy) -> int:
    """Total rank count of the policy's mesh (1 without a mesh)."""
    return 1 if policy is None else policy.device_count


def pad_index(index: _sah.SAHIndex, shards: int) -> _sah.SAHIndex:
    """Pad the cone-block axis to a multiple of ``shards`` with dead leaves
    (``sharding.py:73-109``): cyclic duplicates of real leaves (valid unit
    vectors, so every bound stays finite) with ``user_mask`` False and
    ``block_lb`` +inf, so Lemma 2 kills the block before any per-user work
    and no counter, prediction or scan sees them. The index itself when
    ``n_blocks`` already divides."""
    nb = index.n_blocks
    nb_pad = -(-nb // shards) * shards
    if nb_pad == nb:
        return index
    leaf = index.n_users // nb
    dev = index.users.device
    pad_blocks = torch.arange(nb, nb_pad, device=dev) % nb
    pad_rows = (pad_blocks[:, None] * leaf
                + torch.arange(leaf, device=dev)[None, :]).reshape(-1)

    def dup(x, rows):
        return torch.cat([x, x[rows]])

    return index._replace(
        users=dup(index.users, pad_rows),
        user_ids=dup(index.user_ids, pad_rows),
        user_mask=torch.cat([index.user_mask, torch.zeros(
            pad_rows.shape[0], dtype=torch.bool, device=dev)]),
        theta=dup(index.theta, pad_rows),
        user_lb=dup(index.user_lb, pad_rows),
        center=dup(index.center, pad_blocks),
        omega=dup(index.omega, pad_blocks),
        block_lb=torch.cat([index.block_lb, torch.full(
            (nb_pad - nb, index.kmax), float("inf"),
            dtype=index.block_lb.dtype, device=dev)]))


def shard_slice(index: _sah.SAHIndex, shards: int, s: int
                ) -> _sah.SAHIndex:
    """Shard ``s`` of ``shards`` of an index padded by ``pad_index``: its
    slice of the user and block rows (fresh tensors), the item side as it
    is."""
    nb = index.n_blocks
    if nb % shards:
        raise ValueError(f"{nb} blocks do not divide into {shards} shards: "
                         f"pad_index first")
    b = nb // shards
    u = b * (index.n_users // nb)
    rows = {f: getattr(index, f)[s * u:(s + 1) * u].clone()
            for f in _USER_AXIS_FIELDS}
    rows.update({f: getattr(index, f)[s * b:(s + 1) * b].clone()
                 for f in _BLOCK_AXIS_FIELDS})
    return index._replace(**rows)


def shard_index(index: _sah.SAHIndex, policy) -> _sah.SAHIndex:
    """This rank's shard of ``index`` under ``policy``: the block axis
    padded to the rank count (``pad_index``), then the rank's slice of the
    user and block rows (``sharding.py:148-159``). The index itself
    without a mesh."""
    if not _meshed(policy):
        return index
    s = n_shards(policy)
    return shard_slice(pad_index(index, s), s, shard_rank(policy))


def rkmips_batch(index: _sah.SAHIndex, queries: torch.Tensor, k: int,
                 policy=None, *, n_cand: int = 64, scan: str = "sketch",
                 chunk: int = 256, tie_eps: float = 0.0,
                 scan_precision: str = "f32",
                 delta_items: torch.Tensor | None = None,
                 delta_mask: torch.Tensor | None = None,
                 scan_budget: int = 0):
    """Sharded Algorithm 5 over a query batch (``sharding.py:162-246``).

    Without a mesh, exactly ``core/sah.py::rkmips_batch`` on ``index``.
    Under a mesh, ``index`` is this rank's shard (``shard_index``): the
    rank runs the batched plan/execute on it, with the replicated delta
    buffer counted into its own lanes and ``scan_budget`` held against its
    own charged tiles; then the predictions are gathered along the user
    axis in mesh order and the counters summed. Returns (pred (nq, m_pad)
    bool in the global leaf order of the padded index, QueryStats of
    (nq,) int32 counters), the same on every rank.
    """
    kw = dict(n_cand=n_cand, scan=scan, chunk=chunk, tie_eps=tie_eps,
              scan_precision=scan_precision, scan_budget=scan_budget,
              delta_items=delta_items, delta_mask=delta_mask)
    if not _meshed(policy):
        return _sah.rkmips_batch(index, queries, k, **kw)
    _coll.check_same_call(queries, k, "rkmips_batch", policy.group)
    pred_l, stats_l = _sah.rkmips_batch(index, queries, k, **kw)
    pred = _coll.all_gather_cat(pred_l, policy, dim=1)
    stats = _coll.all_reduce_sum(torch.stack(tuple(stats_l)), policy.group)
    return pred, _sah.QueryStats(*stats.unbind(0))


def pad_item_rows(items: torch.Tensor, item_ids: torch.Tensor,
                  item_mask: torch.Tensor, codes: torch.Tensor,
                  shards: int, k: int = 1):
    """Pad the item-axis arrays so that ``shards`` shards each hold at
    least ``k`` rows and the rows divide evenly (``sharding.py:112``).
    Padding rows are dead: zero vectors, id -1, mask False, zero codes.
    Returns the inputs themselves when nothing needs padding."""
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
        ips = torch.stack([torch.where(item_mask, rows_matmul(items, q), neg)
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


def rank_rows(items: torch.Tensor, item_ids: torch.Tensor,
              item_mask: torch.Tensor, codes: torch.Tensor, policy,
              k: int = 1):
    """The rank's slice of whole item-axis arrays for ``kmips_flat_arrays``
    under a mesh: padded with dead rows (``pad_item_rows``; a serving
    state padded at build has nothing left to add) and cut into equal
    slices in mesh order. The arrays themselves without a mesh."""
    if not _meshed(policy):
        return items, item_ids, item_mask, codes
    s = n_shards(policy)
    rows = pad_item_rows(items, item_ids, item_mask, codes, s, k)
    per = rows[0].shape[0] // s
    lo = shard_rank(policy) * per
    return tuple(r[lo:lo + per] for r in rows)


def kmips_flat_arrays(items: torch.Tensor, item_ids: torch.Tensor,
                      item_mask: torch.Tensor, codes: torch.Tensor,
                      ucodes: torch.Tensor | None, queries: torch.Tensor,
                      k: int, policy=None, *, n_cand: int = 64,
                      scan: str = "sketch"):
    """Single-pass kMIPS over raw row arrays (``sharding.py:288-323``).
    items (N, d) f32, item_ids (N,) int32 (-1 padding), item_mask (N,)
    bool, codes (N, W) int32, ucodes (Q, W) int32 query codes (None under
    ``scan="exact"``), queries (Q, d) -> (vals (Q, k) descending, ids
    (Q, k)). ``n_cand`` is raised to k and capped at the rows scanned.

    Under a mesh the row arrays are the rank's rows (at least k of them,
    ``item_ids`` global; ``rank_rows`` cuts them from whole arrays, as the
    reference's ``shard_map`` does): each rank scans them with ``n_cand``
    per shard, and the local winners are gathered and merged in mesh
    order by a stable top-k; every rank gets the answer. A query's answer
    does not depend on the rest of the batch (module docstring)."""
    n_c = min(max(n_cand, k), items.shape[0])
    if not _meshed(policy):
        return _flat_candidates(items, item_ids, item_mask, codes, ucodes,
                                queries, k, n_c, scan)
    _coll.check_same_call(queries, k, "kmips_flat_arrays", policy.group)
    vals_l, ids_l = _flat_candidates(items, item_ids, item_mask, codes,
                                     ucodes, queries, k, n_c, scan)
    vals = _coll.all_gather_cat(vals_l, policy, dim=1)
    ids = _coll.all_gather_cat(ids_l, policy, dim=1)
    best, pos = kref.topk_stable(vals, k)
    return best, ids.gather(1, pos)


def kmips_flat(index: _alsh.SAALSHIndex, queries: torch.Tensor, k: int,
               policy=None, *, n_cand: int = 64, scan: str = "sketch"):
    """Single-pass kMIPS over a forward index (``sharding.py:326-342``):
    queries (Q, d) -> (vals (Q, k) descending, ids (Q, k) original item
    rows). ``n_cand`` at least the rows a shard scans makes the sketch
    exact. Under a mesh each rank scans its ``rank_rows``; the
    engine's single-device ``kmips`` takes the tiled, early-terminating
    ``sa_alsh.kmips_topk`` instead."""
    ucodes = _alsh.user_codes(index, queries) if scan == "sketch" else None
    rows = rank_rows(index.items, index.item_ids, index.item_mask,
                     index.codes, policy, k)
    return kmips_flat_arrays(*rows, ucodes, queries, k, policy,
                             n_cand=n_cand, scan=scan)

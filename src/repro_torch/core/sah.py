"""SAH: Shifting-aware Asymmetric Hashing for RkMIPS (Algorithms 4-5).

Port of ``src/repro/core/sah.py`` (build ``:61-227``, query
``:230-726``, with the staged-insert delta buffer of an artifact).
SA-ALSH (``sa_alsh.py``) indexes the items, cone blocks (``cone.py``)
and Simpfer lower bounds (``simpfer.py``) the users.

Query, batched in two phases (the reference's DESIGN.md SS9):

  plan -- per query: Lemma 2 kills blocks, Lemma 3 kills users, dense
  tau = users @ q (one product per query, as the reference maps it: a
  single (nq, m) GEMM would round differently; by fixed-shape row chunks,
  ``core/rows.py``, so a user's tau is the same bits in a shard's slice
  of the users as in all of them), the O(1) "no"/"yes"
  decisions; then the undecided (query, user) lanes of the whole batch
  are compacted by a stable sort into one flat query-major work queue.

  execute -- fixed-size, possibly mixed-query chunks of that queue go
  through ``sa_alsh.decide_count``. The reference's while-loop over
  chunks is a host loop here (one sync per chunk, and one per tile step
  inside ``decide_count``).

``rkmips`` is the per-query reference driver; the batched path equals it
bitwise, because every lane's decision depends only on its own user,
tau, count and eps.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from repro_torch.core import cone as _cone
from repro_torch.core import sa_alsh as _alsh
from repro_torch.core import simpfer as _simpfer
from repro_torch.core.rows import rows_matmul


class SAHIndex(NamedTuple):
    """Everything the query phase needs; users live in cone-leaf order."""

    alsh: _alsh.SAALSHIndex          # over P \ P'
    users: torch.Tensor              # (m_pad, d) unit users, leaf order
    user_ids: torch.Tensor           # (m_pad,) int32 original user row
    user_mask: torch.Tensor          # (m_pad,) real (non-duplicate) users
    center: torch.Tensor             # (n_blocks, d)
    omega: torch.Tensor              # (n_blocks,)
    theta: torch.Tensor              # (m_pad,)
    user_lb: torch.Tensor            # (m_pad, kmax)
    block_lb: torch.Tensor           # (n_blocks, kmax)
    top_norms: torch.Tensor          # (n_top,) norms of P', descending
    top_items: torch.Tensor          # (n_top, d) P' item vectors
    top_ids: torch.Tensor            # (n_top,) int32 original rows of P'

    @property
    def n_blocks(self) -> int:
        return self.center.shape[0]

    @property
    def kmax(self) -> int:
        return self.user_lb.shape[1]

    @property
    def n_users(self) -> int:
        return self.users.shape[0]


def _tensor(arrays: Mapping[str, np.ndarray], key: str,
            device) -> torch.Tensor:
    """uint32 arrays (the SRP codes) become their int32 bit views; every
    other dtype (bool, int8, int32, float32) is kept."""
    a = np.asarray(arrays[key])
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def alsh_from_numpy(arrays: Mapping[str, np.ndarray], prefix: str,
                    device) -> _alsh.SAALSHIndex:
    """The port's ``SAALSHIndex`` from numpy arrays named
    ``<prefix><field>``: ``index/alsh/`` for the reverse index's item
    side, ``kmips/`` for the forward index (the artifact layout,
    ``repro/engine/artifact.py:116-134,600-612``)."""
    return _alsh.SAALSHIndex(**{f: _tensor(arrays, prefix + f, device)
                                for f in _alsh.SAALSHIndex._fields})


def index_from_numpy(arrays: Mapping[str, np.ndarray], device) -> SAHIndex:
    """The port's ``SAHIndex`` from a reference index given as numpy
    arrays under the artifact layout's names (``index/alsh/<field>``,
    ``index/<field>``)."""
    alsh = alsh_from_numpy(arrays, "index/alsh/", device)
    rest = {f: _tensor(arrays, f"index/{f}", device)
            for f in SAHIndex._fields if f != "alsh"}
    return SAHIndex(alsh=alsh, **rest)


# ---------------------------------------------------------------------------
# Build stages (Algorithm 4).
# ---------------------------------------------------------------------------


class NormSplit(NamedTuple):
    """Items split into P' (top n_top by norm) and the rest."""

    order: torch.Tensor      # (n,) sorted position -> original row
    top_items: torch.Tensor  # (n_top, d) descending norm
    top_ids: torch.Tensor    # (n_top,) int32
    top_norms: torch.Tensor  # (n_top,) f32 descending
    rest: torch.Tensor       # (n - n_top, d) remaining items, sorted


class UserBlocking(NamedTuple):
    """Users blocked into leaves (cone or norm order)."""

    users: torch.Tensor
    user_ids: torch.Tensor
    user_mask: torch.Tensor
    center: torch.Tensor
    omega: torch.Tensor
    theta: torch.Tensor


def split_items_by_norm(items: torch.Tensor, n_top: int) -> NormSplit:
    """Descending-norm sort (stable) + top-``n_top`` split."""
    norms = torch.linalg.norm(items, dim=-1)
    order = torch.argsort(-norms, stable=True)
    items_sorted = items[order]
    return NormSplit(order=order, top_items=items_sorted[:n_top],
                     top_ids=order[:n_top].to(torch.int32),
                     top_norms=norms[order][:n_top],
                     rest=items_sorted[n_top:])


def shift_item_ids(alsh: _alsh.SAALSHIndex, order: torch.Tensor,
                   n_top: int) -> _alsh.SAALSHIndex:
    """alsh.item_ids index ``rest``; map them back to original item rows
    (padding stays -1)."""
    ids = alsh.item_ids
    shifted = order.to(torch.int32)[torch.clamp(ids, min=0).long() + n_top]
    return alsh._replace(item_ids=torch.where(ids >= 0, shifted, -1))


def unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def block_users(users: torch.Tensor, *,
                generator: torch.Generator | None = None,
                cone_order: torch.Tensor | None = None, leaf_size: int = 32,
                blocking: str = "cone") -> UserBlocking:
    """Unit-normalize users and block them: the cone tree (from
    ``cone_order``, else a permutation drawn from ``generator``) or
    Simpfer-style contiguous "norm" runs."""
    users_unit = unit_rows(users)
    if blocking == "cone":
        if cone_order is None:
            if generator is None:
                raise ValueError("cone blocking needs a generator or a "
                                 "cone_order")
            m_pad, _ = _cone.padded_size(users.shape[0], leaf_size)
            cone_order = torch.randperm(m_pad, generator=generator)
        blocks, padded, mask = _cone.build_cone_blocks(users_unit,
                                                       cone_order, leaf_size)
    elif blocking == "norm":
        blocks, padded, mask = _cone.norm_blocks(users_unit, leaf_size)
    else:
        raise ValueError(f"unknown blocking {blocking!r}")
    perm = blocks.perm.long()
    m = users.shape[0]
    return UserBlocking(users=padded[perm],
                        user_ids=(perm % m).to(torch.int32),
                        user_mask=mask[perm], center=blocks.center,
                        omega=blocks.omega, theta=blocks.theta)


def lower_bounds(users_leaf: torch.Tensor, user_mask: torch.Tensor,
                 top_items: torch.Tensor, k_max: int, n_blocks: int, *,
                 mask: torch.Tensor | None = None, lb_rows=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Simpfer per-user and per-block lower bounds over P' (over the
    members ``mask`` keeps, when given: an artifact's delete view).

    ``lb_rows(users, top_items, k_max) -> (m, k_max)`` replaces the
    per-user bounds (``sah.py:180-195``): the staged build passes a
    row-parallel ``simpfer.user_lower_bounds`` here."""
    if lb_rows is None:
        lb = _simpfer.user_lower_bounds(users_leaf, top_items, k_max,
                                        mask=mask)
    else:
        lb = lb_rows(users_leaf, top_items, k_max)
    block_lb = _simpfer.block_lower_bounds(
        torch.where(user_mask[:, None], lb, float("inf")), n_blocks)
    block_lb = torch.where(torch.isfinite(block_lb), block_lb,
                           float("-inf"))
    return lb, block_lb


def build(items: torch.Tensor, users: torch.Tensor, *,
          generator: torch.Generator | None = None,
          proj: torch.Tensor | None = None,
          cone_order: torch.Tensor | None = None, k_max: int = 50,
          n_top: int | None = None, leaf_size: int = 32, b: float = 0.5,
          n_bits: int = 128, tile: int = 512, max_partitions: int = 64,
          transform: str = "sat", blocking: str = "cone") -> SAHIndex:
    """Build the SAH index (Algorithm 4). items (n, d), users (m, d), on
    the device the index should live on.

    The reference draws two random inputs from its key: the SRP
    projection (d+1, n_bits) and the cone tree's initial permutation of
    the m_pad padded users. ``proj`` and ``cone_order`` inject them (that
    is how the tests hold this build against the reference); whatever is
    not injected is drawn from ``generator``.
    """
    if n_top is None:
        n_top = 2 * k_max
    split = split_items_by_norm(items, n_top)
    alsh = _alsh.build_index(split.rest, generator, proj=proj, b=b,
                             n_bits=n_bits, tile=tile,
                             max_partitions=max_partitions,
                             transform=transform)
    alsh = shift_item_ids(alsh, split.order, n_top)
    ub = block_users(users, generator=generator, cone_order=cone_order,
                     leaf_size=leaf_size, blocking=blocking)
    lb, block_lb = lower_bounds(ub.users, ub.user_mask, split.top_items,
                                k_max, ub.center.shape[0])
    return SAHIndex(alsh=alsh, users=ub.users, user_ids=ub.user_ids,
                    user_mask=ub.user_mask, center=ub.center, omega=ub.omega,
                    theta=ub.theta, user_lb=lb, block_lb=block_lb,
                    top_norms=split.top_norms, top_items=split.top_items,
                    top_ids=split.top_ids)


# ---------------------------------------------------------------------------
# Query (Algorithm 5).
# ---------------------------------------------------------------------------


class QueryStats(NamedTuple):
    """Per-query pruning counters: ints from ``rkmips``, (nq,) int32
    tensors from the batch drivers. The first five are exact and
    layout-independent; tiles_scanned and chunks are packing diagnostics
    (a mixed-query chunk's tile visits are charged to every query with an
    active lane in it)."""

    blocks_alive: torch.Tensor    # after Lemma 2
    users_alive: torch.Tensor     # after Lemma 3
    n_no_lb: torch.Tensor         # decided no by tau < L[k-1]
    n_yes_norm: torch.Tensor      # decided yes by tau >= ||p_k||
    n_scan: torch.Tensor          # users that needed the item scan
    tiles_scanned: torch.Tensor   # total tile visits across chunks
    chunks: torch.Tensor
    truncated: torch.Tensor       # 1 iff a scan budget skipped lanes


class PlanLanes(NamedTuple):
    """One query's plan, all (m_pad,) in cone-leaf order but ``eps`` (())
    and ``block_alive`` ((n_blocks,))."""

    tau: torch.Tensor
    count0: torch.Tensor
    pred0: torch.Tensor
    undecided: torch.Tensor
    eps: torch.Tensor
    block_alive: torch.Tensor
    user_alive: torch.Tensor
    no_lb: torch.Tensor
    yes_norm: torch.Tensor


class DeltaCounts:
    """The staged rows' share of every lane's initial count, for one
    dispatch (``sah.py:308-326``). The (m_pad, cap) product ``users @
    d_items.T`` (by fixed-shape row chunks, ``core/rows.py``, so a shard's
    users get the single-device bits) is made once per dispatch, never per
    query, and dropped
    with it; a lane counts the live rows with ``ip > tau + eps``, the main
    scan's strict rule.

    Under every ``scan_precision`` the counts come from this one f32
    product. The reference screens the buffer with its int8 twin under
    ``"int8"`` and decides only the band exactly, so its counts equal the
    f32 counts by construction; the port skips that screen, whose tables
    (``users @ d_qitems.T``) cost as much as the product they would spare.
    """

    def __init__(self, users: torch.Tensor, d_items: torch.Tensor,
                 d_mask: torch.Tensor):
        self.mask = d_mask
        self.ip = rows_matmul(users, d_items.T)

    def count(self, thr: torch.Tensor) -> torch.Tensor:
        """(m_pad,) int32 live staged rows beating ``thr`` = tau + eps."""
        return (self.mask[None, :] & (self.ip > thr[:, None])).sum(
            dim=-1).to(torch.int32)


def _plan_one(index: SAHIndex, q: torch.Tensor, k: int, tie_eps: float,
              delta: DeltaCounts | None = None) -> PlanLanes:
    """Lemmas 2-3 + dense tau + the O(1) decisions for ONE query
    (``sah.py:248-329``). Shared verbatim by the per-query and the batched
    drivers. ``delta`` adds the live staged rows of an artifact's delta
    buffer to every lane's initial count; the caller must hand an index
    view whose ``top_norms`` covers those rows (``IndexArtifact.
    query_view``)."""
    leaf = index.n_users // index.n_blocks
    qn = torch.linalg.norm(q)
    eps = tie_eps * qn
    # f32 slack: the cone bounds go through arccos/cos round trips
    slack = 2e-4 * qn + eps

    blocks = _cone.ConeBlocks(perm=index.user_ids, center=index.center,
                              omega=index.omega, theta=index.theta)
    node_ub, phi = _cone.node_upper_bound(q, blocks)
    block_alive = node_ub >= index.block_lb[:, k - 1] - slack
    vec_ub = _cone.vector_upper_bound(qn, phi, blocks)
    user_alive = (index.user_mask
                  & torch.repeat_interleave(block_alive, leaf)
                  & (vec_ub >= index.user_lb[:, k - 1] - slack))

    tau = rows_matmul(index.users, q)
    no_lb = index.user_lb[:, k - 1] > tau + eps
    yes_norm = tau >= index.top_norms[k - 1]
    undecided = user_alive & ~no_lb & ~yes_norm
    count0 = _simpfer.init_count(index.user_lb, tau + eps)
    if delta is not None:
        count0 = count0 + delta.count(tau + eps)
    pred0 = yes_norm & index.user_mask
    return PlanLanes(tau, count0, pred0, undecided, eps, block_alive,
                     user_alive, no_lb, yes_norm)


def _undecided_first(undecided: torch.Tensor) -> torch.Tensor:
    """Stable compaction order: undecided lanes first, original order
    kept among them (``argsort(~undecided)``, bool sorted as uint8)."""
    return torch.argsort((~undecided).to(torch.uint8), stable=True)


def _delta(index: SAHIndex, delta_items,
           delta_mask) -> DeltaCounts | None:
    if delta_items is None:
        return None
    return DeltaCounts(index.users, delta_items, delta_mask)


def rkmips(index: SAHIndex, q: torch.Tensor, k: int, *, n_cand: int = 64,
           scan: str = "sketch", chunk: int = 256, tie_eps: float = 0.0,
           scan_precision: str = "f32",
           delta_items: torch.Tensor | None = None,
           delta_mask: torch.Tensor | None = None):
    """Algorithm 5 for one query: the per-query REFERENCE driver
    (``rkmips_impl``, ``sah.py:332-413``). Returns (pred (m_pad,) bool in
    cone-leaf order, QueryStats of Python ints).

    delta_items (cap, d) / delta_mask (cap,): an artifact's staged-insert
    buffer, counted into every lane (``DeltaCounts``), with the same
    counts under every ``scan_precision``."""
    _alsh.check_precision(scan_precision)
    m_pad = index.n_users
    chunk = min(chunk, m_pad)
    p = _plan_one(index, q, k, tie_eps,
                  _delta(index, delta_items, delta_mask))
    und_ids = _undecided_first(p.undecided)
    n_und = int(p.undecided.sum())
    pred = p.pred0.clone()
    lane = torch.arange(chunk, device=q.device)
    ci = tiles = 0
    while ci * chunk < n_und:
        # clamped start, as dynamic_slice clamps: the tail chunk re-covers
        # a few decided lanes (masked) instead of skipping undecided ones
        start = min(ci * chunk, m_pad - chunk)
        ids = und_ids[start:start + chunk]
        active = (start + lane) < n_und
        is_yes, t_vis = _alsh.decide_count(
            index.alsh, index.users[ids], p.tau[ids], p.count0[ids], active,
            k, n_cand=n_cand, scan=scan, eps=p.eps,
            scan_precision=scan_precision)
        pred[ids] = torch.where(active, is_yes, pred[ids])
        ci += 1
        tiles += t_vis
    stats = QueryStats(
        blocks_alive=int(p.block_alive.sum()),
        users_alive=int(p.user_alive.sum()),
        n_no_lb=int((p.no_lb & index.user_mask).sum()),
        n_yes_norm=int((p.yes_norm & index.user_mask).sum()),
        n_scan=n_und, tiles_scanned=tiles, chunks=ci, truncated=0)
    return pred, stats


class RkMIPSPlan(NamedTuple):
    """Phase-1 output of the batched pipeline (``sah.py:422-453``).

    tau/count0/pred0 (nq, m_pad); queue (nq * m_pad,) int64 flat lane ids
    into the row-major grid, undecided first (query-major, cone-leaf
    order kept); n_work int, the undecided count; eps (nq,) f32; the five
    plan-time counters (nq,) int32.
    """

    tau: torch.Tensor
    count0: torch.Tensor
    pred0: torch.Tensor
    queue: torch.Tensor
    n_work: int
    eps: torch.Tensor
    blocks_alive: torch.Tensor
    users_alive: torch.Tensor
    n_no_lb: torch.Tensor
    n_yes_norm: torch.Tensor
    n_scan: torch.Tensor


def rkmips_plan(index: SAHIndex, queries: torch.Tensor, k: int, *,
                tie_eps: float = 0.0,
                delta_items: torch.Tensor | None = None,
                delta_mask: torch.Tensor | None = None) -> RkMIPSPlan:
    """Phase 1: ``_plan_one`` per query (the reference's ``lax.map``),
    then one stable compaction of the whole (nq, m_pad) grid. A delta
    buffer's product (``DeltaCounts``) is made once for the batch."""
    nq = queries.shape[0]
    if nq * index.n_users >= 2 ** 31:
        raise ValueError(
            f"batch too large for the int32 flat work queue: nq * m_pad = "
            f"{nq} * {index.n_users} >= 2**31; split the query batch")
    delta = _delta(index, delta_items, delta_mask)
    plans = [_plan_one(index, queries[i], k, tie_eps, delta)
             for i in range(nq)]
    del delta                # free the (m_pad, cap) product before stacking
    mask = index.user_mask

    def stack(f):
        return torch.stack([f(p) for p in plans])

    def counter(f):
        return stack(lambda p: f(p).sum()).to(torch.int32)

    undecided = stack(lambda p: p.undecided)
    return RkMIPSPlan(
        tau=stack(lambda p: p.tau), count0=stack(lambda p: p.count0),
        pred0=stack(lambda p: p.pred0),
        queue=_undecided_first(undecided.reshape(-1)),
        n_work=int(undecided.sum()), eps=stack(lambda p: p.eps),
        blocks_alive=counter(lambda p: p.block_alive),
        users_alive=counter(lambda p: p.user_alive),
        n_no_lb=counter(lambda p: p.no_lb & mask),
        n_yes_norm=counter(lambda p: p.yes_norm & mask),
        n_scan=counter(lambda p: p.undecided))


def rkmips_execute(index: SAHIndex, plan: RkMIPSPlan, k: int, *,
                   n_cand: int = 64, scan: str = "sketch", chunk: int = 256,
                   scan_precision: str = "f32", scan_budget: int = 0):
    """Phase 2 (``sah.py:526-615``): a host loop over fixed-size, possibly
    mixed-query chunks of the flat queue. Returns (pred (nq, m_pad) bool,
    QueryStats of (nq,) int32 tensors).

    Lane i of the queue belongs to query ``queue[i] // m_pad`` and looks
    up its own user, tau, count and eps. A chunk's tile visits are
    charged to every query with an active lane in it. ``scan_budget > 0``
    caps each query's charged tile visits: once reached, its remaining
    lanes leave later chunks, keep their plan-time decision ("not in the
    audience") and the query is flagged ``truncated``. ``scan_budget <= 0``
    is uncapped, and bitwise the same as no budget at all.
    """
    _alsh.check_precision(scan_precision)
    nq, m_pad = plan.tau.shape
    dev = plan.tau.device
    chunk = min(chunk, nq * m_pad)
    tau_f = plan.tau.reshape(-1)
    count_f = plan.count0.reshape(-1)
    pred = plan.pred0.reshape(-1).clone()
    zeros_q = torch.zeros(nq, dtype=torch.int32, device=dev)
    tiles_q, chunks_q, trunc_q = zeros_q.clone(), zeros_q.clone(), zeros_q
    lane = torch.arange(chunk, device=dev)
    ci = 0
    while ci * chunk < plan.n_work:
        start = min(ci * chunk, nq * m_pad - chunk)
        ids = plan.queue[start:start + chunk]
        in_work = (start + lane) < plan.n_work
        qid = ids // m_pad
        if scan_budget > 0:
            over = tiles_q[qid] >= scan_budget
            active = in_work & ~over
            trunc_q = trunc_q.scatter_reduce(
                0, qid, (in_work & over).to(torch.int32), "amax")
        else:
            active = in_work
        is_yes, t_vis = _alsh.decide_count(
            index.alsh, index.users[ids % m_pad], tau_f[ids], count_f[ids],
            active, k, n_cand=n_cand, scan=scan, eps=plan.eps[qid],
            scan_precision=scan_precision)
        pred[ids] = torch.where(active, is_yes, pred[ids])
        present = zeros_q.scatter_reduce(0, qid, active.to(torch.int32),
                                         "amax")
        tiles_q += present * t_vis
        chunks_q += present
        ci += 1
    stats = QueryStats(
        blocks_alive=plan.blocks_alive, users_alive=plan.users_alive,
        n_no_lb=plan.n_no_lb, n_yes_norm=plan.n_yes_norm,
        n_scan=plan.n_scan, tiles_scanned=tiles_q, chunks=chunks_q,
        truncated=trunc_q)
    return pred.reshape(nq, m_pad), stats


def rkmips_batch(index: SAHIndex, queries: torch.Tensor, k: int, *,
                 n_cand: int = 64, scan: str = "sketch", chunk: int = 256,
                 tie_eps: float = 0.0, scan_precision: str = "f32",
                 scan_budget: int = 0,
                 delta_items: torch.Tensor | None = None,
                 delta_mask: torch.Tensor | None = None):
    """Batched Algorithm 5: plan + execute. (nq, d) queries -> (pred
    (nq, m_pad), QueryStats of (nq,) counters); bitwise the stack of
    per-query ``rkmips`` predictions and plan-time counters. The delta
    buffer threads through the plan as in ``rkmips``."""
    _alsh.check_precision(scan_precision)
    plan = rkmips_plan(index, queries, k, tie_eps=tie_eps,
                       delta_items=delta_items, delta_mask=delta_mask)
    return rkmips_execute(index, plan, k, n_cand=n_cand, scan=scan,
                          chunk=chunk, scan_precision=scan_precision,
                          scan_budget=scan_budget)


def rkmips_batch_mapped(index: SAHIndex, queries: torch.Tensor, k: int, *,
                        n_cand: int = 64, scan: str = "sketch",
                        chunk: int = 256, tie_eps: float = 0.0,
                        scan_precision: str = "f32",
                        delta_items: torch.Tensor | None = None,
                        delta_mask: torch.Tensor | None = None):
    """The legacy batch driver (``sah.py:688-711``): the per-query
    ``rkmips`` run for each query in turn, as the reference's ``lax.map``
    runs its while-loops, the predictions stacked to (nq, m_pad) and each
    counter to an (nq,) int32 tensor. It is the second reference the
    batched driver is held against (predictions and plan counters
    bitwise; ``tiles_scanned`` and ``chunks`` are packing counts, equal
    for nq = 1) and the baseline the batched driver's time is compared
    with. Always unbudgeted.

    The reference also takes ``delta_qitems``/``delta_qscale``, the int8
    twin of the staged rows its int8 screen reads; the port counts staged
    rows in f32 under both precisions (PORT.md, "Index artifacts"), so the
    mapped driver takes ``delta_items``/``delta_mask`` alone, each query
    counting them as ``rkmips`` does."""
    per = [rkmips(index, q, k, n_cand=n_cand, scan=scan, chunk=chunk,
                  tie_eps=tie_eps, scan_precision=scan_precision,
                  delta_items=delta_items, delta_mask=delta_mask)
           for q in queries]
    pred = torch.stack([p for p, _ in per])
    stats = QueryStats(*(
        torch.tensor([getattr(s, f) for _, s in per], dtype=torch.int32,
                     device=queries.device) for f in QueryStats._fields))
    return pred, stats


def predictions_to_original(index: SAHIndex, pred: torch.Tensor,
                            n_users: int) -> torch.Tensor:
    """Leaf-order predictions (..., m_pad) -> original rows (..., m).

    Padded rows are masked off, and ids outside [0, n_users) are dropped
    before the scatter, never clamped onto a real user."""
    masked = (pred & index.user_mask).to(torch.int32)
    ids = index.user_ids.long()
    keep = (ids >= 0) & (ids < n_users)
    masked, ids = masked[..., keep], ids[keep]
    out = torch.zeros(pred.shape[:-1] + (n_users,), dtype=torch.int32,
                      device=pred.device)
    out.scatter_reduce_(-1, ids.expand(masked.shape), masked, "amax")
    return out > 0

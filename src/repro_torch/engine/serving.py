"""Online serving: micro-batched (R)kMIPS behind one front door (port of
``src/repro/engine/serving.py:76-813``, DESIGN.md §8; the port's
restatement is PORT.md, "Serving").

Single queries arrive one at a time, are grouped into micro-batches of
``serve_batch_size`` (or padded up to the nearest rung of the config's
bucket ladder) and dispatched through the flat scan
``engine/sharding.py::kmips_flat_arrays``. Padding is dead, and every
query's answer is computed by expressions that do not depend on the rest
of the batch, so a query's answer is bitwise the same alone, in any
micro-batch, at any rung, or in a one-shot batch.

Forward (kMIPS) serving, in three layers:

  * ``build_serving_state``: the forward SA-ALSH index as serving arrays
    (norm-ordered rows, codes, the query-side projection);
  * ``ServingCache``: an LRU of built states keyed by (corpus
    fingerprint, index recipe); ``builds`` counts its misses;
  * ``RetrievalServer``: ``submit`` returns tickets, ``flush`` answers
    every pending ticket in order, ``kmips`` is submit + flush for one.

An artifact-backed server keys its cache by the artifact's base
fingerprint and serves the staged changes as an overlay: deleted rows
leave the scan's mask (memoized per bound version), live staged rows are
merged into every answer (``sa_alsh.merge_delta_topk``, under both scan
precisions), with ids ``n_base + slot``. ``swap(artifact)`` makes a new
version live between flushes; pending tickets survive it.

Reverse (RkMIPS) serving is a ticket queue over
``RkMIPSEngine.query_batch`` (``ReverseServer``).

Warmup and ``compile_count`` are restated for eager PyTorch (PORT.md):
each server counts the distinct dispatch signatures it has run, in a set
that ``share_dispatch`` shares; ``warmup`` runs one dispatch on zero
queries for each cell the reference's warmup compiles.

Under a mesh policy (one process per rank, SPMD) a forward state's item
rows are padded once, at build, to the shard multiple
(``sharding.pad_item_rows``; padding rows are dead), and every dispatch
scans this rank's slice and merges the ranks' winners
(``sharding.kmips_flat_arrays``); the reverse server rides on the mesh
engine's sharded ``query_batch``. Every rank makes the same calls in the
same order; the threaded runtime keeps that order for its dispatches
through the mesh's dispatch stream (``engine/controller.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple

import torch

from repro_torch.core import sa_alsh as _alsh
from repro_torch.core import sah as _sah
from repro_torch.core import srp as _srp
from repro_torch.dist.policy import NO_SHARDING, ShardingPolicy
from repro_torch.engine import sharding as _sharding
from repro_torch.engine.artifact import (IndexArtifact, as_key, as_rows,
                                         corpus_fingerprint, device_of)
from repro_torch.engine.config import EngineConfig, get_config
from repro_torch.kernels import ops as kops


class ServingState(NamedTuple):
    """What one config's online scan needs: the forward index's rows in
    descending-norm order, padded to a tile multiple with dead rows;
    ``item_ids`` maps back to the caller's rows."""

    items: torch.Tensor       # (N_pad, d) f32
    item_ids: torch.Tensor    # (N_pad,) int32, -1 on padding
    item_mask: torch.Tensor   # (N_pad,) bool
    codes: torch.Tensor       # (N_pad, W) int32 bit views
    proj_q: torch.Tensor      # (d, n_bits) query-side SRP projection
    config: EngineConfig
    n_items: int              # real (unpadded) rows, k's upper bound


class ServeResult(NamedTuple):
    """One served query's answer: values (k,) descending, ids (k,) in the
    caller's row space (artifact id space for artifact-backed servers:
    base rows keep their ids, staged slot j is n_base + j), and k."""

    values: torch.Tensor
    ids: torch.Tensor
    k: int


def _config(config) -> EngineConfig:
    return get_config(config) if isinstance(config, str) else config


def state_from_index(index: _alsh.SAALSHIndex,
                     config: EngineConfig | str = "sah", *,
                     policy: ShardingPolicy = NO_SHARDING) -> ServingState:
    """A serving state over an already built forward index, no rebuild.
    Under a mesh policy the item rows are padded with dead rows to the
    shard multiple (``serving.py:104-124``); every rank holds them all and
    scans its slice."""
    arrays = (index.items, index.item_ids, index.item_mask, index.codes)
    if policy.mesh is not None:
        arrays = _sharding.pad_item_rows(*arrays,
                                         _sharding.n_shards(policy))
    return ServingState(*arrays, index.proj[:-1], _config(config),
                        int(index.item_mask.sum()))


def build_serving_state(items, config: EngineConfig | str = "sah", *,
                        proj=None, generator: torch.Generator | None = None,
                        device=None,
                        policy: ShardingPolicy = NO_SHARDING) -> ServingState:
    """Build the forward index of ``items`` (n, d) as serving arrays on
    ``device`` (None means "cuda"). The SRP projection is ``proj``
    ((d+1, n_bits)) or drawn from ``generator``, as
    ``sa_alsh.build_index`` takes them (the reference derives it from its
    key): a server and an engine given the same projection and config
    scan identical codes. ``policy``: pad the rows for its mesh
    (``state_from_index``); the build itself is the same on every rank."""
    config = _config(config)
    items = as_rows(items, "items", device_of(device, "build_serving_state"))
    idx = _alsh.build_index(items, generator,
                            proj=None if proj is None
                            else as_rows(proj, "proj", items.device),
                            **config.kmips_build_kwargs(items.shape[0]))
    return state_from_index(idx, config, policy=policy)


def validate_query_rows(q, dim: int | None, what: str,
                        device=None) -> torch.Tensor:
    """Submit-time validation shared by every ticket surface: a clear
    ``ValueError`` for a query of a non-floating dtype, of a rank other
    than 1 or 2, or of another dimensionality than the corpus's (``dim``;
    None skips that check). Returns it as float32 on ``device`` (None:
    where it is)."""
    t = torch.as_tensor(q)
    if not t.is_floating_point():
        raise ValueError(f"{what}: queries must have a floating dtype, "
                         f"got {str(t.dtype).removeprefix('torch.')}")
    if t.dim() not in (1, 2):
        raise ValueError(f"{what}: queries must be one row (d,) or a "
                         f"block (nq, d), got shape {tuple(t.shape)}")
    if dim is not None and t.shape[-1] != dim:
        raise ValueError(f"{what}: query dimensionality {t.shape[-1]} != "
                         f"corpus dimensionality {dim}")
    return t.to(device=t.device if device is None else device,
                dtype=torch.float32)


def _index_recipe(config: EngineConfig, n_items: int) -> tuple:
    """The build kwargs that determine the built serving arrays
    (``EngineConfig.kmips_build_kwargs``): configs that differ only in
    serving or query knobs share one cached state."""
    return tuple(sorted(config.kmips_build_kwargs(n_items).items()))


class ServingCache:
    """LRU of built ``ServingState``s keyed by (corpus fingerprint, index
    recipe) (``serving.py:180-267``).

    ``fingerprint`` identifies the live corpus version
    (``IndexArtifact.base_fingerprint`` for artifact-backed servers,
    ``corpus_fingerprint(items, key)`` otherwise, computed at first use);
    ``rebind`` points the cache at a new version and keeps the old
    versions' entries under their own fingerprints. A miss builds with the
    cache's projection when it fits the recipe's ``n_bits``, else with a
    projection drawn from a generator in the state ``generator`` had when
    the cache was made, so that a rebuild of an evicted recipe gives the
    same codes. States are built under ``policy`` (``state_from_index``);
    the key does not name the mesh, as in the reference.
    """

    def __init__(self, items, key, *, proj=None,
                 generator: torch.Generator | None = None,
                 capacity: int = 4, fingerprint: str | None = None,
                 device=None, policy: ShardingPolicy = NO_SHARDING):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.device = _sharding.policy_device(policy, device, "ServingCache")
        self.policy = policy
        self.capacity = capacity
        self._states: OrderedDict[tuple, ServingState] = OrderedDict()
        self.builds = 0
        self.rebind(items, key, proj=proj, generator=generator,
                    fingerprint=fingerprint)

    def __len__(self) -> int:
        return len(self._states)

    @property
    def fingerprint(self) -> str:
        """Fingerprint of the live corpus version (the key prefix)."""
        if self._fp is None:
            self._fp = corpus_fingerprint(self._items, self._key)
        return self._fp

    def rebind(self, items, key, *, proj=None,
               generator: torch.Generator | None = None,
               fingerprint: str | None = None) -> None:
        """Make a new corpus version live (a hot swap). States of earlier
        versions stay retrievable under their fingerprints."""
        self._items = as_rows(items, "items", self.device)
        self._key = as_key(key)
        self._proj = None if proj is None else as_rows(proj, "proj",
                                                       self.device)
        self._gen_state = None if generator is None else \
            generator.get_state()
        self._fp = fingerprint

    def _recipe(self, config: EngineConfig) -> tuple:
        return (self.fingerprint,
                _index_recipe(config, self._items.shape[0]))

    def __contains__(self, config: EngineConfig) -> bool:
        return self._recipe(config) in self._states

    def _insert(self, recipe: tuple, state: ServingState) -> None:
        self._states[recipe] = state
        self._states.move_to_end(recipe)
        while len(self._states) > self.capacity:
            self._states.popitem(last=False)

    def put(self, config: EngineConfig | str, state: ServingState) -> None:
        """Seed the cache with a built state (no build counted)."""
        config = _config(config)
        self._insert(self._recipe(config), state)

    def _projection(self, config: EngineConfig) -> torch.Tensor:
        want = (self._items.shape[1] + 1, config.n_bits)
        if self._proj is not None and tuple(self._proj.shape) == want:
            return self._proj
        if self._gen_state is None:
            have = None if self._proj is None else tuple(self._proj.shape)
            raise ValueError(f"no projection for n_bits={config.n_bits}: "
                             f"the server's proj is {have}, not {want}, "
                             f"and it was given no generator")
        gen = torch.Generator().set_state(self._gen_state)
        return _srp.make_projection(gen, *want, self.device)

    def get(self, config: EngineConfig | str) -> ServingState:
        """The state for ``config``: cached on a hit, built and inserted
        on a miss (evicting the least recently used past capacity)."""
        config = _config(config)
        recipe = self._recipe(config)
        state = self._states.get(recipe)
        if state is not None:
            self._states.move_to_end(recipe)
            return state
        state = build_serving_state(self._items, config,
                                    proj=self._projection(config),
                                    device=self.device, policy=self.policy)
        self.builds += 1
        self._insert(recipe, state)
        return state


class _TicketQueue:
    """Ticket bookkeeping shared by the two servers (``serving.py:
    270-324``): FIFO tickets, validated at submit; ``flush`` consumes the
    queue only on success, so a failed flush leaves every ticket pending
    and a retry answers them all."""

    def __init__(self, dim: int | None, device: torch.device):
        self._pending: list[torch.Tensor] = []
        self._next_ticket = 0
        self._dim = dim
        self.device = device

    @property
    def pending(self) -> int:
        """Tickets submitted but not yet flushed."""
        return len(self._pending)

    def submit(self, q) -> int | list[int]:
        """Enqueue a query (d,) -> its ticket; (nq, d) -> one per row.
        The next ``flush`` answers tickets in submission order; a
        malformed query raises ``ValueError`` here."""
        q = validate_query_rows(q, self._dim, "submit", self.device)
        if q.dim() == 1:
            self._pending.append(q)
            self._next_ticket += 1
            return self._next_ticket - 1
        tickets = list(range(self._next_ticket,
                             self._next_ticket + q.shape[0]))
        self._pending.extend(q.unbind(0))
        self._next_ticket += q.shape[0]
        return tickets

    def _serve_one(self, q, flush, what: str):
        if torch.as_tensor(q).dim() != 1:
            raise ValueError(f"{what} serves one query (d,); use "
                             f"submit/flush for batches")
        ticket = self.submit(q)
        first = self._next_ticket - len(self._pending)
        return flush()[ticket - first]

    def _ladder(self) -> tuple:
        raise NotImplementedError

    @property
    def batch_size(self) -> int:
        raise NotImplementedError

    def bucket_for(self, n: int) -> int:
        """The dispatch size ``n`` queries pad up to: the smallest rung of
        the live config's ``bucket_ladder()`` that fits them."""
        if not 1 <= n <= self.batch_size:
            raise ValueError(f"group of {n} outside [1, "
                             f"batch_size={self.batch_size}]")
        return next(b for b in self._ladder() if b >= n)

    def _flush_all(self, flush_batch) -> list:
        if not self._pending:
            return []
        batch = self.batch_size
        queue = list(self._pending)
        out = []
        for i in range(0, len(queue), batch):
            out.extend(flush_batch(queue[i:i + batch]))
        del self._pending[:len(queue)]
        return out


class RetrievalServer(_TicketQueue):
    """Online kMIPS serving (``serving.py:327-657``).

    ``RetrievalServer(items, key, proj=... | generator=...)``: ``key`` is
    the corpus's uint32 (2,) tag (``artifact.as_key``), hashed with the
    items into the cache's fingerprint; the forward projection is an
    input, or drawn from a generator (PORT.md, "Random draws are
    inputs"). ``from_artifact`` binds an artifact's base corpus, its
    projection and base fingerprint, with the staged changes as an overlay
    (module docstring).

    ``compile_count`` is the number of distinct dispatch signatures run
    through this server's dispatch, shared with every server made with
    ``share_dispatch=`` it: one per (rung, k, n_cand, scan) and state
    shape, and one per (rung, k, n_base) delta merge.

    ``policy``: a mesh policy shards the scan over item rows (module
    docstring); the server then lives on the rank's device, and a
    ``share_dispatch`` donor must be on the same mesh.
    """

    def __init__(self, items, key, *, config: EngineConfig | str = "sah",
                 proj=None, generator: torch.Generator | None = None,
                 fingerprint: str | None = None,
                 share_dispatch: "RetrievalServer | None" = None,
                 device=None, policy: ShardingPolicy = NO_SHARDING):
        dev = _sharding.policy_device(policy, device, "RetrievalServer")
        items = as_rows(items, "items", dev)
        super().__init__(items.shape[1], dev)
        self.policy = policy
        self.config = _config(config)
        self.artifact: IndexArtifact | None = None
        self._n_items: int | None = None
        self._delta = (None, None)
        self._deleted: torch.Tensor | None = None
        self._mask_memo = None
        self.cache = ServingCache(items, key, proj=proj, generator=generator,
                                  capacity=self.config.serve_cache_capacity,
                                  fingerprint=fingerprint, device=dev,
                                  policy=policy)
        if share_dispatch is None:
            self._sigs: set = set()
            return
        if not isinstance(share_dispatch, RetrievalServer):
            raise TypeError("share_dispatch must be a RetrievalServer, got "
                            f"{type(share_dispatch).__name__}")
        if share_dispatch.device != dev:
            raise ValueError("share_dispatch requires a server on the same "
                             "device")
        if share_dispatch.policy.mesh is not policy.mesh:
            raise ValueError("share_dispatch requires the same sharding "
                             "policy mesh")
        self._sigs = share_dispatch._sigs

    @property
    def compile_count(self) -> int:
        """Distinct dispatch signatures run (class docstring)."""
        return len(self._sigs)

    @classmethod
    def from_artifact(cls, artifact: IndexArtifact, *,
                      policy: ShardingPolicy = NO_SHARDING,
                      share_dispatch: "RetrievalServer | None" = None
                      ) -> "RetrievalServer":
        """A server over an artifact's corpus, on the artifact's device
        (under a mesh, the rank's device, which the artifact's must be):
        base items, forward projection and base fingerprint
        (``serving_base``), seeded from the artifact's forward index when
        it is built; answers in artifact id space."""
        items, proj, fp = artifact.serving_base()
        srv = cls(items, artifact.key, config=artifact.config, proj=proj,
                  fingerprint=fp, share_dispatch=share_dispatch,
                  device=artifact.device, policy=policy)
        srv._bind_artifact(artifact)
        return srv

    def _bind_artifact(self, artifact: IndexArtifact) -> None:
        if artifact.device != self.device:
            raise ValueError(f"the artifact lives on {artifact.device} and "
                             f"this server on {self.device}")
        self.artifact = artifact
        self._n_items = artifact.n_items
        self._delta = artifact.kmips_delta()
        self._deleted = artifact.deleted if bool(artifact.deleted.any()) \
            else None
        self._mask_memo = None
        if artifact.kmips_index is not None \
                and artifact.config not in self.cache:
            self.cache.put(artifact.config, state_from_index(
                artifact.kmips_index, artifact.config, policy=self.policy))

    def _masked_item_mask(self, state: ServingState) -> torch.Tensor:
        """The state's scan mask with the bound version's deleted base
        rows retired, memoized per (state, bound version). Padding rows
        (id -1, under a mesh too) stay dead: their mask is already
        False."""
        if self._deleted is None:
            return state.item_mask
        if self._mask_memo is not None and self._mask_memo[0] is state:
            return self._mask_memo[1]
        ids = state.item_ids.long()
        dead = (ids >= 0) & self._deleted[ids.clamp(min=0)]
        mask = state.item_mask & ~dead
        self._mask_memo = (state, mask)
        return mask

    def swap(self, artifact: IndexArtifact) -> "RetrievalServer":
        """Make a new artifact version live between flushes; pending
        tickets survive. A delta descendant of the live base reuses the
        cached state; earlier bases stay cached under their
        fingerprints."""
        if artifact.device != self.device:
            raise ValueError(f"the artifact lives on {artifact.device} and "
                             f"this server on {self.device}")
        items, proj, fp = artifact.serving_base()
        self.config = artifact.config
        self.cache.capacity = artifact.config.serve_cache_capacity
        self.cache.rebind(items, artifact.key, proj=proj, fingerprint=fp)
        self._dim = items.shape[1]
        self._bind_artifact(artifact)
        return self

    @property
    def batch_size(self) -> int:
        """The live config's micro-batch size."""
        return self.config.serve_batch_size

    def _ladder(self) -> tuple:
        return self.config.bucket_ladder()

    def _scan(self, state: ServingState, mask: torch.Tensor,
              qs: torch.Tensor, k: int, n_cand: int, scan: str):
        self._sigs.add(("scan", qs.shape[0], k, n_cand, scan,
                        tuple(state.items.shape), tuple(state.codes.shape)))
        ucodes = kops.srp_hash(qs, state.proj_q) if scan == "sketch" \
            else None
        rows = _sharding.rank_rows(state.items, state.item_ids, mask,
                                   state.codes, self.policy, k)
        return _sharding.kmips_flat_arrays(*rows, ucodes, qs, k, self.policy,
                                           n_cand=n_cand, scan=scan)

    def _merge(self, vals, ids, qs, d_items, d_mask, k: int, n_base: int):
        self._sigs.add(("merge", qs.shape[0], k, n_base,
                        tuple(d_items.shape)))
        return _alsh.merge_delta_topk(vals, ids, qs, d_items, d_mask, k,
                                      n_base)

    def _flush_batch(self, group: list, k: int, *,
                     n_cand: int | None = None, scan: str | None = None,
                     pad_to: int | None = None) -> list[ServeResult]:
        """Answer one micro-batch (at most ``pad_to`` queries, default
        ``batch_size``), padded with zero queries: THE flush path, shared
        by ``flush`` and the threaded runtime's workers."""
        state = self.cache.get(self.config)
        bound = state.n_items if self.artifact is None else self._n_items
        if not 1 <= k <= bound:
            raise ValueError(f"k={k} outside [1, {bound}] "
                             f"supported by this corpus")
        n_cand = self.config.n_cand if n_cand is None else n_cand
        scan = self.config.scan if scan is None else scan
        batch = self.batch_size if pad_to is None else pad_to
        if len(group) > batch:
            raise ValueError(f"group of {len(group)} does not fit "
                             f"pad_to={batch}")
        qs = torch.stack(group)
        if len(group) < batch:
            qs = torch.cat([qs, qs.new_zeros(batch - len(group),
                                             qs.shape[1])])
        vals, ids = self._scan(state, self._masked_item_mask(state), qs, k,
                               n_cand, scan)
        d_items, d_mask = self._delta
        if d_items is not None:
            vals, ids = self._merge(vals, ids, qs, d_items, d_mask, k,
                                    self.artifact.n_base)
        return [ServeResult(vals[j], ids[j], k) for j in range(len(group))]

    def warmup(self, ks, *, n_cands=None, scans=None,
               buckets=None) -> int:
        """First use of every (bucket, k, n_cand, scan) dispatch cell, and
        of the delta merge when an artifact is bound (on its buffer
        arrays, so the first staged insert adds no signature): one
        dispatch on zero queries per cell (PORT.md, "Serving"). Defaults:
        the config's n_cand and scan and its ``bucket_ladder()``. Returns
        the number of cells."""
        state = self.cache.get(self.config)
        mask = self._masked_item_mask(state)
        n_cands = ((self.config.n_cand,) if n_cands is None
                   else tuple(n_cands))
        scans = (self.config.scan,) if scans is None else tuple(scans)
        buckets = self._ladder() if buckets is None else tuple(buckets)
        art = self.artifact
        cells = 0
        for b in buckets:
            qs = state.items.new_zeros(b, state.items.shape[1])
            for k in tuple(ks):
                for nc in n_cands:
                    for sc in scans:
                        vals, ids = self._scan(state, mask, qs, k, nc, sc)
                        cells += 1
                if art is not None:
                    self._merge(vals, ids, qs, art.delta_items,
                                art.delta_mask, k, art.n_base)
                    cells += 1
        return cells

    def flush(self, k: int, *, n_cand: int | None = None,
              scan: str | None = None) -> list[ServeResult]:
        """Answer every pending ticket, in submission order, in
        micro-batches of ``serve_batch_size`` (the last one padded to
        it). k/n_cand/scan default to the config's. A failed dispatch
        (or a bad k) raises and consumes nothing."""
        return self._flush_all(lambda g: self._flush_batch(
            g, k, n_cand=n_cand, scan=scan))

    def kmips(self, q, k: int, *, n_cand: int | None = None,
              scan: str | None = None) -> ServeResult:
        """Serve one query now: submit + flush (pending tickets are
        answered by the same flush, in order)."""
        return self._serve_one(
            q, lambda: self.flush(k, n_cand=n_cand, scan=scan), "kmips")


class ReverseResult(NamedTuple):
    """One served reverse query's answer (``serving.py:660-681``):
    predictions (m,) bool in original user rows; stats, the query's row of
    ``core.sah.QueryStats``; k; truncated, True iff a scan budget cut the
    query short (its answer is then conservative); funnel, the
    dispatch's ``PruningFunnel``."""

    predictions: torch.Tensor
    stats: object
    k: int
    truncated: bool = False
    funnel: object = None


class ReverseServer(_TicketQueue):
    """Online RkMIPS serving: a ticket queue over
    ``RkMIPSEngine.query_batch`` (``serving.py:684-813``). A partial group
    is padded by repeating its first query (a real vector; its rows are
    computed and dropped), the same on every rank of a mesh engine, whose
    ``query_batch`` is sharded. ``compile_count`` is the engine's
    ``rkmips_compile_count``. Needs a user-side build."""

    def __init__(self, engine):
        index = engine.index              # raises unless built for RkMIPS
        super().__init__(index.users.shape[-1], engine.device)
        self.engine = engine

    def swap(self, artifact: IndexArtifact) -> "ReverseServer":
        """Re-attach the engine to a new version between flushes; pending
        tickets survive. A kMIPS-only artifact is refused before the
        engine is touched."""
        if artifact.users is None:
            raise RuntimeError(
                "cannot swap a kMIPS-only artifact into a ReverseServer: "
                "the artifact is not built for RkMIPS (users=None)")
        self.engine.attach(artifact)
        self._dim = self.engine.index.users.shape[-1]
        return self

    @property
    def batch_size(self) -> int:
        """Micro-batch size, from the engine's config."""
        return self.engine.config.serve_batch_size

    def _ladder(self) -> tuple:
        return self.engine.config.bucket_ladder()

    @property
    def compile_count(self) -> int:
        """The engine's distinct reverse dispatch signatures."""
        return self.engine.rkmips_compile_count

    def warmup(self, ks, *, buckets=None) -> int:
        """``RkMIPSEngine.warmup`` at every rung (default: the ladder).
        Returns the number of cells."""
        buckets = self._ladder() if buckets is None else tuple(buckets)
        return self.engine.warmup(ks, batch_sizes=buckets)

    def _flush_batch(self, group: list, k: int, *,
                     pad_to: int | None = None) -> list[ReverseResult]:
        """Answer one micro-batch through the engine's batched dispatch,
        repeat-padded to ``pad_to`` (default ``batch_size``): THE flush
        path, shared by ``flush`` and the runtime's workers."""
        batch = self.batch_size if pad_to is None else pad_to
        if len(group) > batch:
            raise ValueError(f"group of {len(group)} does not fit "
                             f"pad_to={batch}")
        qs = torch.stack(group)
        if len(group) < batch:
            qs = torch.cat([qs, qs[:1].expand(batch - len(group), -1)])
        res = self.engine.query_batch(qs, k)
        trunc = res.stats.truncated.tolist()
        return [ReverseResult(res.predictions[j],
                              _sah.QueryStats(*(s[j] for s in res.stats)),
                              k, truncated=trunc[j] > 0, funnel=res.funnel)
                for j in range(len(group))]

    def flush(self, k: int) -> list[ReverseResult]:
        """Answer every pending ticket; results in submission order."""
        return self._flush_all(lambda g: self._flush_batch(g, k))

    def rkmips(self, q, k: int) -> ReverseResult:
        """Serve one reverse query now: submit + flush."""
        return self._serve_one(q, lambda: self.flush(k), "rkmips")

"""RkMIPSEngine: the front door for reverse k-MIPS (RkMIPS) in the port.

A twin of ``src/repro/engine/engine.py``: build an index
from one ``EngineConfig``, answer reverse queries in original user-id
space, check them against the exact oracle with the same ``tie_eps``, and
answer forward top-k MIPS over the items:

    eng = RkMIPSEngine("sah").build(items, users, generator)
    res = eng.query_batch(promoted_items, k=10)   # res.predictions (nq, m)
    truth = eng.oracle(promoted_items, k=10)
    top = eng.kmips(user_rows, k=10)              # top.values, top.ids (Q, k)

Building is "make an ``IndexArtifact``, then ``attach`` it"; an engine
equally serves a saved or mutated version (``engine/artifact.py``):

    art = IndexArtifact.load("/ckpt/sah")
    eng = RkMIPSEngine.from_artifact(art)
    eng.attach(art.insert_items(new_rows).delete_items(old_ids))

An attached version's staged changes are served as the reference serves
them: deleted rows leave the scans, live staged rows are counted exactly
into every reverse lane and merged into every forward answer with ids
``n_base + slot``, and ``oracle`` judges against the effective corpus.

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do): with no CUDA device the default
raises. Tau, the lower bounds and the exact re-rank feed discrete
decisions, so float32 products must stay float32: the engine turns off
TF32 for matrix products and for cuDNN when it is made.

Online serving rides on the engine: ``server()`` and
``reverse_server()`` (``engine/serving.py``), their threaded runtimes
``async_server()`` and ``async_reverse_server()`` (``engine/runtime.py``),
and ``warmup``. ``rkmips_compile_count`` counts the distinct reverse
dispatch signatures (batch shape, k, delta buffer, index shapes) run
through this engine's dispatch, shared with every engine made with
``share_dispatch=`` it (PORT.md, "Serving"); ``query_batch_mapped``, the
legacy per-query driver, counts its own in
``rkmips_mapped_compile_count``.

Under a mesh policy (``dist.ShardingPolicy`` over a ``DeviceMesh``; one
process per rank, SPMD) the engine lives on the rank's own device, builds
with the row-parallel stages, keeps the padded index (``index``) and its
rank's shard of the user rows, and answers ``query_batch``, ``query`` and
``kmips`` through ``engine/sharding.py``: every rank makes each call with
the same arguments and gets the whole answer, bitwise the single-device
one (``kmips``: the single-pass sharded scan, as in the reference). The
servers ride on the same mesh: ``server()`` shards its item rows, and a
``ServingRuntime`` over a mesh server orders every dispatch through the
mesh's dispatch stream (``engine/controller.py``).
"""

from __future__ import annotations

import time
import warnings
from typing import NamedTuple

import torch

from repro_torch.core import exact as _exact
from repro_torch.core import sa_alsh as _alsh
from repro_torch.core import sah as _sah
from repro_torch.dist.policy import NO_SHARDING, ShardingPolicy
from repro_torch.engine import artifact as _artifact
from repro_torch.engine import sharding as _sharding
from repro_torch.engine.artifact import as_rows
from repro_torch.engine.config import EngineConfig, get_config
from repro_torch.kernels.hamming_scan import SELECT_MAX_ROWS, SELECT_MAX_WORDS


class PruningFunnel(NamedTuple):
    """Aggregate pruning funnel of one RkMIPS batch, summed over queries:
    blocks -> users -> scan lanes -> tiles. ``blocks_total`` and
    ``users_total`` are nq times the counts the counters are measured
    against; ``tiles_scanned``/``chunks`` are packing diagnostics."""

    queries: int
    blocks_total: int
    blocks_alive: int
    users_total: int
    users_alive: int
    decided_no_lb: int
    decided_yes_norm: int
    scan_lanes: int
    tiles_scanned: int
    chunks: int
    truncated: int = 0

    def format(self) -> str:
        """One human-readable funnel line."""
        tail = (f" ({self.truncated} budget-truncated)"
                if self.truncated else "")
        return (f"{self.queries} queries: "
                f"blocks {self.blocks_alive}/{self.blocks_total} alive -> "
                f"users {self.users_alive}/{self.users_total} alive -> "
                f"scan lanes {self.scan_lanes} "
                f"(no-by-bound {self.decided_no_lb}, "
                f"yes-by-norm {self.decided_yes_norm}) -> "
                f"{self.tiles_scanned} tile-visits in {self.chunks} chunks"
                f"{tail}")


class QueryResult(NamedTuple):
    """One RkMIPS answer, mapped to original user rows.

    predictions: bool (m,) for query() / (nq, m) for query_batch();
    stats: ``core.sah.QueryStats``; seconds: wall time of the call, to
    the end of its device work; k; funnel: the batch's PruningFunnel.
    """

    predictions: torch.Tensor
    stats: _sah.QueryStats
    seconds: float
    k: int
    funnel: PruningFunnel | None = None


class KMIPSResult(NamedTuple):
    """Forward top-k MIPS answer: values (k,) / (Q, k) descending, ids
    original item rows, the tiles the scan visited, the wall seconds of
    the call to the end of its device work, and k."""

    values: torch.Tensor
    ids: torch.Tensor
    tiles_visited: int
    seconds: float
    k: int


def check_kernel_limits(config: EngineConfig, device_type: str) -> None:
    """Raise ``ValueError`` for a config whose queries would reach a limit
    of a CUDA kernel on ``device_type`` ("cuda"), naming the kernel and the
    limit; the CPU's plain versions have none. The sketch scan selects
    each tile's candidates on the card in ``hamming_nearest`` (f32 scan,
    forward kMIPS) or ``fused_scan`` (int8 scan), which take tiles of at
    most ``SELECT_MAX_ROWS`` rows and codes of at most
    ``SELECT_MAX_WORDS`` words. ``srp_hash`` and the exact scan take any
    config the reference's ``EngineConfig`` accepts."""
    if device_type != "cuda" or config.scan != "sketch":
        return
    kernels = ("fused_scan and hamming_nearest"
               if config.scan_precision == "int8" else "hamming_nearest")
    if config.tile > SELECT_MAX_ROWS:
        raise ValueError(f"tile={config.tile} is past the CUDA {kernels} "
                         f"limit of {SELECT_MAX_ROWS} rows a tile for "
                         f"scan='sketch'; use a smaller tile, scan='exact' "
                         f"or device='cpu'")
    if config.n_bits // 32 > SELECT_MAX_WORDS:
        raise ValueError(f"n_bits={config.n_bits} is past the CUDA {kernels} "
                         f"limit of {32 * SELECT_MAX_WORDS} bits "
                         f"({SELECT_MAX_WORDS} words) for scan='sketch'; use "
                         f"fewer bits, scan='exact' or device='cpu'")


class RkMIPSEngine:
    """Config-driven RkMIPS engine, serving one attached ``IndexArtifact``
    version at a time.

    config: an ``EngineConfig`` or a registry name ("sah", "simpfer", ...).
    policy: ``NO_SHARDING``, or a mesh policy: then the user rows (reverse)
            and item rows (forward) shard over every mesh axis.
    device: where the index lives and the queries run; None means "cuda",
            or under a mesh the rank's own device (``rank_device``), which
            a given device must equal.
    share_dispatch: another engine whose dispatch signature set this one
            adopts (the gateway's shared trace cache, DESIGN.md §15): the
            configs must agree in every field but ``scan_budget``, on the
            same device and mesh.
    """

    def __init__(self, config: EngineConfig | str = "sah", *,
                 policy: ShardingPolicy = NO_SHARDING, device=None,
                 share_dispatch: "RkMIPSEngine | None" = None):
        if isinstance(config, str):
            config = get_config(config)
        if not isinstance(config, EngineConfig):
            raise TypeError(f"config must be an EngineConfig or a registry "
                            f"name, got {type(config).__name__}")
        self.device = _sharding.policy_device(policy, device,
                                              "RkMIPSEngine")
        self.policy = policy
        check_kernel_limits(config, self.device.type)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.artifact: _artifact.IndexArtifact | None = None
        self.build_seconds: float | None = None
        self.n_users: int | None = None
        self._index: _sah.SAHIndex | None = None
        self._shard: _sah.SAHIndex | None = None
        self._n_blocks = 0
        self._index_sig: tuple = ()
        self._items: torch.Tensor | None = None
        self._users_unit: torch.Tensor | None = None
        self._delta: tuple = (None, None)
        self._mapped_sigs: set = set()
        if share_dispatch is None:
            self._sigs: set = set()
            return
        donor = share_dispatch
        if not isinstance(donor, RkMIPSEngine):
            raise TypeError(f"share_dispatch expects an RkMIPSEngine, "
                            f"got {type(donor).__name__}")
        # the budget is a per-engine operand; every other knob shapes the
        # dispatch the signatures stand for
        if donor.config.replace(scan_budget=config.scan_budget) != config:
            raise ValueError(
                "share_dispatch requires configs equal in every field "
                "except scan_budget (the budget is a traced operand; "
                "all other query knobs bake into the shared trace)")
        if donor.device != self.device:
            raise ValueError("share_dispatch requires an engine on the same "
                             "device")
        if donor.policy.mesh is not policy.mesh:
            raise ValueError("share_dispatch requires the same sharding "
                             "policy mesh")
        self._sigs = donor._sigs

    @property
    def rkmips_compile_count(self) -> int:
        """Distinct reverse dispatch signatures run, shared with every
        engine in this engine's ``share_dispatch`` group."""
        return len(self._sigs)

    @property
    def rkmips_mapped_compile_count(self) -> int:
        """Distinct signatures run through ``query_batch_mapped`` (batch
        shape, k, delta buffer, index shapes), where the reference counts
        the traces of its mapped dispatch; this engine's own."""
        return len(self._mapped_sigs)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build(self, items, users, generator: torch.Generator | None = None,
              *, proj=None, cone_order=None, kmips_proj=None
              ) -> "RkMIPSEngine":
        """Index ``items`` (n, d) for ``users`` (m, d). Returns self.

        ``attach(IndexArtifact.build(...))`` with this engine's config and
        device. ``proj`` ((d+1, n_bits) f32) and ``cone_order`` (a
        permutation of the m_pad padded users) inject the reverse build's
        two random draws, and ``kmips_proj`` ((d+1, n_bits) f32) the
        projection of the forward index over all items; the artifact's key
        and whatever is not injected come from ``generator`` (a CPU
        generator, seeded 0 when None), the key first and the forward
        projection last. ``users=None`` builds only the forward index, at
        once; otherwise it is built at the first ``kmips``. Under a mesh
        the row-parallel stages shard over it (``config.build_sharding``),
        the same artifact bit for bit.
        """
        t0 = time.perf_counter()
        art = _artifact.IndexArtifact.build(
            items, users, generator, config=self.config, proj=proj,
            cone_order=cone_order, kmips_proj=kmips_proj, device=self.device,
            policy=self.policy)
        self.attach(art)
        self._sync()
        self.build_seconds = time.perf_counter() - t0
        return self

    @classmethod
    def from_artifact(cls, artifact: "_artifact.IndexArtifact", *,
                      policy: ShardingPolicy = NO_SHARDING,
                      device=None) -> "RkMIPSEngine":
        """An engine with the artifact's own config serving ``artifact``
        under ``policy``; ``device`` (None means "cuda", or the rank's
        device under a mesh) must be the artifact's. The artifact is
        mesh-agnostic: one saved from any mesh, or from one device,
        attaches."""
        return cls(artifact.config, policy=policy,
                   device=device).attach(artifact)

    def attach(self, artifact: "_artifact.IndexArtifact") -> "RkMIPSEngine":
        """Make ``artifact`` the engine's live version. Returns self.

        The configs must agree but for the knobs that change no answer
        (``delta_capacity``, ``build_sharding``, ``scan_precision``,
        ``scan_budget``), as the reference requires (``engine.py:
        325-342``). Wires up the delta buffer when a staged row is live.
        Under a mesh, pads the block axis to the rank count and keeps this
        rank's shard of the user rows (``sharding.shard_index``); the
        artifact itself stays whole."""
        if not isinstance(artifact, _artifact.IndexArtifact):
            raise TypeError(f"attach expects an IndexArtifact, got "
                            f"{type(artifact).__name__}")
        if artifact.config.replace(
                delta_capacity=self.config.delta_capacity,
                build_sharding=self.config.build_sharding,
                scan_precision=self.config.scan_precision,
                scan_budget=self.config.scan_budget) != self.config:
            raise ValueError(
                "artifact config does not match this engine's config; use "
                "RkMIPSEngine.from_artifact(artifact) (or rebuild the "
                "artifact with the engine's config)")
        if artifact.device != self.device:
            raise ValueError(f"the artifact lives on {artifact.device} and "
                             f"this engine on {self.device}; load or build "
                             f"it with device={str(self.device)!r}")
        self.artifact = artifact
        self._items = artifact.effective_items()
        self._index = self._shard = self._users_unit = self.n_users = None
        self._index_sig = ()
        if artifact.users is None:
            # no reverse index, but live staged rows still join kmips
            self._delta = artifact.kmips_delta()
            artifact.ensure_kmips_index()
            return self
        # query_view owns the liveness rule: the buffer it returns is the
        # one its top_norms covers
        view, d_items, d_mask = artifact.query_view()
        self._delta = (d_items, d_mask)
        self._n_blocks = view.n_blocks
        self._index = _sharding.pad_index(view,
                                          _sharding.n_shards(self.policy))
        self._shard = _sharding.shard_index(self._index, self.policy)
        self._index_sig = _shapes(self._shard)
        self.n_users = artifact.n_users
        self._users_unit = artifact.users_unit()
        return self

    def _require_artifact(self) -> "_artifact.IndexArtifact":
        if self.artifact is None:
            raise RuntimeError("engine not built: call "
                               "build(items, users, generator) first")
        return self.artifact

    @property
    def index(self) -> _sah.SAHIndex:
        """The attached reverse query view (read-only by convention); under
        a mesh, padded to the rank count (``sharding.pad_index``)."""
        if self._index is None:
            raise RuntimeError("engine not built for reverse queries: call "
                               "build(items, users, generator) first")
        return self._index

    @property
    def kmips_index(self) -> _alsh.SAALSHIndex:
        """The base corpus's forward index that ``kmips`` scans, built at
        its first use and memoized on the attached artifact."""
        return self._require_artifact().ensure_kmips_index()

    @property
    def build_timings(self):
        """The attached artifact's ``BuildTimings`` (engine/build.py), or
        None when it was loaded or wired from pieces."""
        return None if self.artifact is None else self.artifact.build_timings

    def _check_k(self, k: int) -> None:
        if not 1 <= k <= self.config.k_max:
            raise ValueError(f"k={k} outside [1, k_max={self.config.k_max}] "
                             f"supported by this index; rebuild with a "
                             f"larger k_max")

    def _funnel(self, stats: _sah.QueryStats, nq: int) -> PruningFunnel:
        def tot(x):
            return int(torch.as_tensor(x).sum())
        return PruningFunnel(
            queries=nq, blocks_total=nq * self._n_blocks,
            blocks_alive=tot(stats.blocks_alive),
            users_total=nq * self.n_users,
            users_alive=tot(stats.users_alive),
            decided_no_lb=tot(stats.n_no_lb),
            decided_yes_norm=tot(stats.n_yes_norm),
            scan_lanes=tot(stats.n_scan),
            tiles_scanned=tot(stats.tiles_scanned),
            chunks=tot(stats.chunks),
            truncated=int((torch.as_tensor(stats.truncated) > 0).sum()))

    def _dispatch(self, queries: torch.Tensor, k: int, delta: tuple):
        """The reverse dispatch: one batched plan/execute over the
        attached view (under a mesh: over this rank's shard, then gathered,
        ``sharding.rkmips_batch``) with ``delta`` = (d_items, d_mask) or
        (None, None), noting its signature."""
        d_items, d_mask = delta
        self._sigs.add((tuple(queries.shape), k,
                        None if d_items is None else tuple(d_items.shape),
                        self._index_sig))
        return _sharding.rkmips_batch(
            self._shard, queries, k, self.policy, n_cand=self.config.n_cand,
            scan=self.config.scan, chunk=self.config.chunk,
            tie_eps=self.config.tie_eps,
            scan_precision=self.config.scan_precision,
            scan_budget=self.config.scan_budget, delta_items=d_items,
            delta_mask=d_mask)

    def query_batch(self, queries, k: int) -> QueryResult:
        """RkMIPS for a batch (nq, d) -> predictions (nq, m), through the
        batched plan/execute pipeline (``core.sah.rkmips_batch``), with
        the attached version's staged changes."""
        index = self.index
        self._check_k(k)
        queries = as_rows(queries, "queries", self.device)
        t0 = time.perf_counter()
        pred, stats = self._dispatch(queries, k, self._delta)
        po = _sah.predictions_to_original(index, pred, self.n_users)
        self._sync()
        return QueryResult(po, stats, time.perf_counter() - t0, k,
                           self._funnel(stats, queries.shape[0]))

    def query_batch_mapped(self, queries, k: int) -> QueryResult:
        """The legacy batch driver (``core.sah.rkmips_batch_mapped``: the
        per-query driver run for each query in turn), with the attached
        version's staged changes; predictions and plan counters bitwise
        ``query_batch``'s. Retained as the baseline the batched pipeline
        is compared with and as a second reference for equivalence tests.
        Single-device only, as in the reference: the sharded path is the
        batched pipeline's."""
        index = self.index
        self._check_k(k)
        if self.policy.mesh is not None:
            raise RuntimeError("query_batch_mapped is the single-device "
                               "reference driver; use query_batch under a "
                               "mesh policy")
        queries = as_rows(queries, "queries", self.device)
        d_items, d_mask = self._delta
        self._mapped_sigs.add((tuple(queries.shape), k,
                               None if d_items is None
                               else tuple(d_items.shape), self._index_sig))
        t0 = time.perf_counter()
        pred, stats = _sah.rkmips_batch_mapped(
            index, queries, k, n_cand=self.config.n_cand,
            scan=self.config.scan, chunk=self.config.chunk,
            tie_eps=self.config.tie_eps,
            scan_precision=self.config.scan_precision, delta_items=d_items,
            delta_mask=d_mask)
        po = _sah.predictions_to_original(index, pred, self.n_users)
        self._sync()
        return QueryResult(po, stats, time.perf_counter() - t0, k,
                           self._funnel(stats, queries.shape[0]))

    def warmup(self, ks, *, batch_sizes=None) -> int:
        """First use of the reverse dispatch at every (batch, k) cell the
        reference's warmup compiles (``engine.py:493-541``): one dispatch
        on zero queries per cell, for the live delta buffer and, when the
        artifact has none live, for its empty buffer too (the signature
        its first staged insert brings). ``batch_sizes`` defaults to the
        config's ``bucket_ladder()``; under a mesh every rank runs every
        cell, as the reference's eager mesh dispatch does (``engine.py:
        531``). Zero queries give tau = 0: the plan
        decides "no" every lane whose k-th lower bound is positive (on
        MF data, every lane), so a warmup scans little. Returns the
        number of cells."""
        users = self.index.users             # raises unless built
        batch_sizes = (self.config.bucket_ladder() if batch_sizes is None
                       else tuple(batch_sizes))
        deltas = [self._delta]
        if self.artifact is not None and self._delta[0] is None:
            deltas.append((self.artifact.delta_items,
                           self.artifact.delta_mask))
        cells = 0
        for b in batch_sizes:
            qs = users.new_zeros(b, users.shape[-1])
            for k in tuple(ks):
                self._check_k(k)
                for delta in deltas:
                    self._dispatch(qs, k, delta)
                    cells += 1
        self._sync()
        return cells

    def query(self, q, k: int) -> QueryResult:
        """RkMIPS for one query (d,): a batch of one through the same
        pipeline as ``query_batch``."""
        res = self.query_batch(torch.as_tensor(q)[None], k)
        stats = _sah.QueryStats(*(s[0] for s in res.stats))
        return res._replace(predictions=res.predictions[0], stats=stats)

    def kmips(self, q, k: int, *, n_cand: int | None = None) -> KMIPSResult:
        """Approximate top-k MIPS over the effective items
        (``core/sa_alsh.py::kmips_topk``, tiled and early-terminating).
        q: (d,) or (Q, d). Deleted rows are masked out of the scan, and
        live staged rows are merged in (``sa_alsh.merge_delta_topk``, the
        same answers under every ``scan_precision``) with ids
        ``n_base + slot``. ``n_cand`` overrides
        the config's re-rank depth and is clamped to the tile.

        Under a mesh: the single-pass scan sharded over item rows
        (``sharding.kmips_flat``, ``n_cand`` per shard and not clamped),
        which covers every row, so ``tiles_visited`` is the tile count."""
        art = self._require_artifact()
        index = art.kmips_query_view()
        if not 1 <= k <= self._items.shape[0]:
            raise ValueError(f"k={k} outside [1, n_items="
                             f"{self._items.shape[0]}]")
        n_cand = self.config.n_cand if n_cand is None else n_cand
        q = torch.as_tensor(q)
        single = q.dim() == 1
        queries = as_rows(q[None] if single else q, "queries", self.device)
        t0 = time.perf_counter()
        if self.policy.mesh is not None:
            vals, ids = _sharding.kmips_flat(index, queries, k, self.policy,
                                             n_cand=n_cand,
                                             scan=self.config.scan)
            tiles = index.tile_max_norm.shape[0]
        else:
            vals, ids, tiles = _alsh.kmips_topk(
                index, queries, k, n_cand=min(n_cand, index.tile),
                scan=self.config.scan)
        d_items, d_mask = self._delta
        if d_items is not None:
            vals, ids = _alsh.merge_delta_topk(
                vals, ids, queries, d_items, d_mask, k, art.n_base)
        self._sync()
        seconds = time.perf_counter() - t0
        if single:
            vals, ids = vals[0], ids[0]
        return KMIPSResult(vals, ids, tiles, seconds, k)

    # -- online serving ----------------------------------------------------

    def server(self):
        """A ``RetrievalServer`` over the attached artifact (its config,
        this engine's device and policy), seeded from the artifact's
        forward index when it is built (``engine/serving.py``)."""
        from repro_torch.engine import serving as _serving
        return _serving.RetrievalServer.from_artifact(
            self._require_artifact(), policy=self.policy)

    def reverse_server(self):
        """A ``ReverseServer`` over this engine: a ticket queue over
        ``query_batch`` (sharded under a mesh). Requires a user-side
        build."""
        from repro_torch.engine import serving as _serving
        return _serving.ReverseServer(self)

    def async_server(self, **runtime_kwargs):
        """A threaded ``ServingRuntime`` over ``server()``
        (``engine/runtime.py``); keyword args go to ``ServingRuntime``."""
        from repro_torch.engine import runtime as _runtime
        return _runtime.ServingRuntime(self.server(), **runtime_kwargs)

    def async_reverse_server(self, **runtime_kwargs):
        """A threaded ``ServingRuntime`` over ``reverse_server()``."""
        from repro_torch.engine import runtime as _runtime
        return _runtime.ServingRuntime(self.reverse_server(),
                                       **runtime_kwargs)

    def oracle(self, queries, k: int) -> torch.Tensor:
        """Exact RkMIPS truth (nq, m) over the attached version's
        effective corpus, with the engine's own ``tie_eps``."""
        if self._users_unit is None:
            raise RuntimeError("engine not built: call "
                               "build(items, users, generator) first")
        queries = torch.as_tensor(queries)
        if queries.dim() == 1:
            queries = queries[None]
        queries = as_rows(queries, "queries", self.device)
        return _exact.rkmips_batch_chunked(self._items, self._users_unit,
                                           queries, k,
                                           tie_eps=self.config.tie_eps)


def _shapes(nt) -> tuple:
    """The shapes of a NamedTuple's tensor leaves, nested ones included."""
    return tuple(_shapes(v) if hasattr(v, "_fields")
                 else tuple(v.shape) if isinstance(v, torch.Tensor) else v
                 for v in nt)


def serving_codes(item_vecs, generator: torch.Generator | None = None, *,
                  n_bits: int = 256, config: EngineConfig | None = None,
                  key=None, kmips_proj=None, device=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """DEPRECATED offline sketch build (``engine.py:649-673``); use

        art = IndexArtifact.build(item_vecs, None, generator,
                                  config=cfg.replace(n_bits=n_bits))
        codes, proj_q = art.serving_codes()

    which this shim builds and forwards to: ``(codes (n, W) int32 bit
    views of the reference's uint32, proj_q (d, n_bits))``. ``key``,
    ``kmips_proj`` and ``generator`` are ``IndexArtifact.build``'s."""
    warnings.warn(
        "repro_torch.engine.serving_codes is deprecated: build an "
        "IndexArtifact and call artifact.serving_codes() (see "
        "engine/artifact.py)", DeprecationWarning, stacklevel=2)
    cfg = (config or get_config("sah")).replace(n_bits=n_bits)
    art = _artifact.IndexArtifact.build(item_vecs, None, generator,
                                        config=cfg, key=key,
                                        kmips_proj=kmips_proj, device=device)
    return art.serving_codes()

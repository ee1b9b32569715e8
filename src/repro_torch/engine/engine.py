"""RkMIPSEngine: the front door for reverse k-MIPS (RkMIPS) in the port.

A slim twin of ``src/repro/engine/engine.py`` (``:64-115`` for the
result types): build an index from one ``EngineConfig``, answer reverse
queries in original user-id space, and check them against the exact
oracle with the same ``tie_eps``:

    eng = RkMIPSEngine("sah").build(items, users, generator)
    res = eng.query_batch(promoted_items, k=10)   # res.predictions (nq, m)
    truth = eng.oracle(promoted_items, k=10)

The engine runs on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do): with no CUDA device the default
raises. Tau, the lower bounds and the exact re-rank feed discrete
decisions, so float32 products must stay float32: the engine turns off
TF32 for matrix products and for cuDNN when it is made.

Not here yet (later slices of the port): artifacts and corpus deltas,
meshes, warmup, forward kMIPS and the servers.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch.core import exact as _exact
from repro_torch.core import sah as _sah
from repro_torch.engine.config import EngineConfig, get_config


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


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "RkMIPSEngine runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def _as_rows(x, name: str, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(x)
    if t.dim() != 2 or t.shape[0] < 1:
        raise ValueError(f"{name} must be a non-empty 2-D (rows, d) array, "
                         f"got shape {tuple(t.shape)}")
    if not t.is_floating_point():
        raise ValueError(f"{name} must have a floating dtype, got {t.dtype}")
    return t.to(device=device, dtype=torch.float32).contiguous()


class RkMIPSEngine:
    """Config-driven RkMIPS engine on one device.

    config: an ``EngineConfig`` or a registry name ("sah", "simpfer", ...).
    device: where the index lives and the queries run; None means "cuda".
    """

    def __init__(self, config: EngineConfig | str = "sah", *, device=None):
        if isinstance(config, str):
            config = get_config(config)
        if not isinstance(config, EngineConfig):
            raise TypeError(f"config must be an EngineConfig or a registry "
                            f"name, got {type(config).__name__}")
        self.device = _device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.build_seconds: float | None = None
        self.n_users: int | None = None
        self._index: _sah.SAHIndex | None = None
        self._items: torch.Tensor | None = None
        self._users_unit: torch.Tensor | None = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def build(self, items, users, generator: torch.Generator | None = None,
              *, proj=None, cone_order=None) -> "RkMIPSEngine":
        """Index ``items`` (n, d) for ``users`` (m, d). Returns self.

        ``proj`` ((d+1, n_bits) f32) and ``cone_order`` (a permutation of
        the m_pad padded users) inject the build's two random draws;
        whatever is not injected comes from ``generator`` (a CPU
        generator, seeded 0 when None).
        """
        cfg = self.config
        items = _as_rows(items, "items", self.device)
        users = _as_rows(users, "users", self.device)
        if users.shape[1] != items.shape[1]:
            raise ValueError(f"users dimensionality ({users.shape[1]}) != "
                             f"items dimensionality ({items.shape[1]})")
        if cfg.scan_precision != "f32":
            raise NotImplementedError(
                "scan_precision='int8' is ported in the next slice of the "
                "port; use scan_precision='f32'")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if proj is not None:
            proj = _as_rows(proj, "proj", self.device)
        if cone_order is not None:
            cone_order = torch.as_tensor(cone_order).to(torch.int64)
        t0 = time.perf_counter()
        self._index = _sah.build(items, users, generator=generator,
                                 proj=proj, cone_order=cone_order,
                                 **cfg.build_kwargs())
        self._sync()
        self.build_seconds = time.perf_counter() - t0
        self._items = items
        self._users_unit = _sah.unit_rows(users)
        self.n_users = users.shape[0]
        return self

    @property
    def index(self) -> _sah.SAHIndex:
        """The built index (read-only by convention)."""
        if self._index is None:
            raise RuntimeError("engine not built: call "
                               "build(items, users, generator) first")
        return self._index

    def _check_k(self, k: int) -> None:
        if not 1 <= k <= self.config.k_max:
            raise ValueError(f"k={k} outside [1, k_max={self.config.k_max}] "
                             f"supported by this index; rebuild with a "
                             f"larger k_max")

    def _funnel(self, stats: _sah.QueryStats, nq: int) -> PruningFunnel:
        def tot(x):
            return int(torch.as_tensor(x).sum())
        return PruningFunnel(
            queries=nq, blocks_total=nq * self.index.n_blocks,
            blocks_alive=tot(stats.blocks_alive),
            users_total=nq * self.n_users,
            users_alive=tot(stats.users_alive),
            decided_no_lb=tot(stats.n_no_lb),
            decided_yes_norm=tot(stats.n_yes_norm),
            scan_lanes=tot(stats.n_scan),
            tiles_scanned=tot(stats.tiles_scanned),
            chunks=tot(stats.chunks),
            truncated=int((torch.as_tensor(stats.truncated) > 0).sum()))

    def query_batch(self, queries, k: int) -> QueryResult:
        """RkMIPS for a batch (nq, d) -> predictions (nq, m), through the
        batched plan/execute pipeline (``core.sah.rkmips_batch``)."""
        index = self.index
        self._check_k(k)
        queries = _as_rows(queries, "queries", self.device)
        t0 = time.perf_counter()
        pred, stats = _sah.rkmips_batch(
            index, queries, k, n_cand=self.config.n_cand,
            scan=self.config.scan, chunk=self.config.chunk,
            tie_eps=self.config.tie_eps,
            scan_precision=self.config.scan_precision,
            scan_budget=self.config.scan_budget)
        po = _sah.predictions_to_original(index, pred, self.n_users)
        self._sync()
        return QueryResult(po, stats, time.perf_counter() - t0, k,
                           self._funnel(stats, queries.shape[0]))

    def query(self, q, k: int) -> QueryResult:
        """RkMIPS for one query (d,): a batch of one through the same
        pipeline as ``query_batch``."""
        res = self.query_batch(torch.as_tensor(q)[None], k)
        stats = _sah.QueryStats(*(s[0] for s in res.stats))
        return res._replace(predictions=res.predictions[0], stats=stats)

    def oracle(self, queries, k: int) -> torch.Tensor:
        """Exact RkMIPS truth (nq, m) with the engine's own ``tie_eps``."""
        if self._users_unit is None:
            raise RuntimeError("engine not built: call "
                               "build(items, users, generator) first")
        queries = torch.as_tensor(queries)
        if queries.dim() == 1:
            queries = queries[None]
        queries = _as_rows(queries, "queries", self.device)
        return _exact.rkmips_batch_chunked(self._items, self._users_unit,
                                           queries, k,
                                           tie_eps=self.config.tie_eps)

"""EngineConfig + the baseline method registry.

A field-for-field copy of ``src/repro/engine/config.py:33-289``, kept in
the port so that it imports nothing of the reference package. Every knob
of an (R)kMIPS run lives in one frozen, hashable ``EngineConfig``; the
paper's baseline matrix is a registry of preset configs:

  | name        | user blocking | item transform | item scan |
  |-------------|---------------|----------------|-----------|
  | sah         | cone          | sat            | sketch    |
  | sa-simpfer  | norm          | sat            | sketch    |
  | h2-cone     | cone          | qnf            | sketch    |
  | h2-simpfer  | norm          | qnf            | sketch    |
  | simpfer     | norm          | sat (unused)   | exact     |
  | exact       | cone          | sat (unused)   | exact     |

The port's engine reads the build and query knobs; the serving, delta and
build-sharding knobs are validated and carried for the slices that port
those layers. ``tie_eps`` is shared by build, query and the exact oracle.
"""

from __future__ import annotations

import dataclasses

TIE_EPS_DEFAULT = 1e-5

_TRANSFORMS = ("sat", "qnf")
_BLOCKINGS = ("cone", "norm")
_SCANS = ("sketch", "exact")
_BUILD_SHARDINGS = ("auto", "single", "sharded")
_SCAN_PRECISIONS = ("f32", "int8")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """All knobs of one (R)kMIPS engine run. Frozen and hashable.

    Index-build knobs (core/sah.py::build):
      k_max:          largest query-time k the index supports.
      n_top:          |P'| top-norm items held out for Simpfer lower bounds
                      (None -> 2 * k_max, the build default).
      leaf_size:      cone-block leaf size N0.
      b:              norm-partition interval ratio (Algorithm 1).
      n_bits:         SRP sketch width (bits; W = n_bits // 32 words).
      tile:           item-scan tile size (rows per Cauchy-Schwarz bound).
      max_partitions: cap on norm partitions T.
      transform:      "sat" (SA-ALSH) or "qnf" (H2-ALSH).
      blocking:       "cone" (Cone-Tree leaves) or "norm" (Simpfer blocks).

    Query knobs (core/sah.py::rkmips):
      scan:    "sketch" (Hamming candidates) or "exact" (linear scan).
      n_cand:  sketch candidates re-ranked per tile.
      chunk:   survivor-compaction chunk size.
      tie_eps: relative tie tolerance, shared with the oracle (core/exact.py).
      scan_precision: "f32" (stock float tile scan) or "int8" (quantized
               screen + banded exact re-rank fed by the fused Pallas
               kernel, DESIGN.md SS13). Execution-only: predictions are
               bitwise identical either way, so — like ``build_sharding``
               — it is excluded from the artifact fingerprint and from
               ``attach`` config equality, and the plan phase ignores it.
      scan_budget: per-query tile-visit cap for the reverse execute phase
               (0 = uncapped, the default). The serving gateway's defence
               against adversarial queries crafted to defeat SRP-code
               pruning (DESIGN.md SS15): once a query's charged
               tile-visits reach the budget, its remaining lanes resolve
               conservatively ("not in the audience") and the result is
               flagged ``truncated`` — never silently wrong. Execution-
               only like ``scan_precision`` (excluded from fingerprints
               and ``attach`` equality), and deliberately NOT part of
               ``query_kwargs()``: the engine threads it as a *traced*
               int32 operand so tenants with different budgets share one
               compiled trace.

    Online-serving knobs (engine/serving.py, DESIGN.md SS8, SS14):
      serve_batch_size:     micro-batch size the RetrievalServer pads
                            accumulated queries to (static shape: exactly
                            one compile per distinct batch size).
      serve_buckets:        ascending dispatch sizes below
                            ``serve_batch_size`` the serving runtime may
                            pad a partial micro-batch up to instead of the
                            full batch (e.g. ``(1, 2, 4)`` for a
                            power-of-two ladder under a batch of 8). Empty
                            (the default) keeps the single-size contract:
                            every dispatch pads to ``serve_batch_size``.
                            Each rung is one more static shape — one trace
                            each, all precompiled by ``warmup()`` — and
                            bucket-padded dispatch is bitwise equal to the
                            unbucketed flush (padding is dead either way).
                            Execution-only like ``serve_batch_size``: not
                            part of any build recipe or cache key.
      serve_cache_capacity: LRU capacity of the built-serving-state cache
                            (states are keyed by the artifact fingerprint
                            + the config's item-index recipe).

    Artifact-lifecycle knobs (engine/artifact.py, DESIGN.md SS10):
      delta_capacity: slots of the staged-insert delta buffer an
                      ``IndexArtifact`` carries between compactions. The
                      capacity is a static shape: attached engines compile
                      the delta pipeline at most once per batch shape, no
                      matter how often the corpus churns. Not part of any
                      build recipe (two configs differing only here share
                      serving state and produce identical indexes).

    Build-execution knobs (engine/build.py, DESIGN.md SS11):
      build_sharding: how the staged build pipeline runs its row-parallel
                      stages — "auto" (shard when the policy carries a
                      multi-device mesh, the default), "single" (always
                      single-device), or "sharded" (require a mesh).
                      Execution-only: the built index is bitwise identical
                      either way, so the knob is excluded from the
                      artifact fingerprint and from ``attach`` config
                      equality (like ``delta_capacity``, it is not part of
                      the build recipe).
    """

    k_max: int = 50
    n_top: int | None = None
    leaf_size: int = 32
    b: float = 0.5
    n_bits: int = 128
    tile: int = 512
    max_partitions: int = 64
    transform: str = "sat"
    blocking: str = "cone"
    scan: str = "sketch"
    n_cand: int = 64
    chunk: int = 256
    tie_eps: float = TIE_EPS_DEFAULT
    serve_batch_size: int = 8
    serve_buckets: tuple = ()
    serve_cache_capacity: int = 4
    delta_capacity: int = 256
    build_sharding: str = "auto"
    scan_precision: str = "f32"
    scan_budget: int = 0

    def __post_init__(self):
        if self.build_sharding not in _BUILD_SHARDINGS:
            raise ValueError(f"build_sharding must be one of "
                             f"{_BUILD_SHARDINGS}, "
                             f"got {self.build_sharding!r}")
        if self.transform not in _TRANSFORMS:
            raise ValueError(f"transform must be one of {_TRANSFORMS}, "
                             f"got {self.transform!r}")
        if self.blocking not in _BLOCKINGS:
            raise ValueError(f"blocking must be one of {_BLOCKINGS}, "
                             f"got {self.blocking!r}")
        if self.scan not in _SCANS:
            raise ValueError(f"scan must be one of {_SCANS}, "
                             f"got {self.scan!r}")
        if self.scan_precision not in _SCAN_PRECISIONS:
            raise ValueError(f"scan_precision must be one of "
                             f"{_SCAN_PRECISIONS}, "
                             f"got {self.scan_precision!r}")
        for name in ("k_max", "leaf_size", "n_bits", "tile",
                     "max_partitions", "n_cand", "chunk",
                     "serve_batch_size", "serve_cache_capacity",
                     "delta_capacity"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.scan_budget < 0:
            raise ValueError(f"scan_budget must be >= 0 (0 = uncapped), "
                             f"got {self.scan_budget}")
        if self.n_top is not None and self.n_top < self.k_max:
            raise ValueError(f"n_top ({self.n_top}) must be >= k_max "
                             f"({self.k_max})")
        if not 0.0 < self.b < 1.0:
            raise ValueError(f"b must be in (0, 1), got {self.b}")
        if self.tie_eps < 0.0:
            raise ValueError(f"tie_eps must be >= 0, got {self.tie_eps}")
        if self.n_bits % 32 != 0:
            raise ValueError(f"n_bits must be a multiple of 32, "
                             f"got {self.n_bits}")
        # normalize to a tuple so the config stays hashable when callers
        # pass a list; validation then pins the ladder shape
        object.__setattr__(self, "serve_buckets",
                           tuple(self.serve_buckets))
        for bkt in self.serve_buckets:
            if not isinstance(bkt, int) or isinstance(bkt, bool):
                raise ValueError(f"serve_buckets must hold ints, got "
                                 f"{bkt!r}")
            if not 1 <= bkt <= self.serve_batch_size:
                raise ValueError(f"serve_buckets entries must be in "
                                 f"[1, serve_batch_size="
                                 f"{self.serve_batch_size}], got {bkt}")
        if list(self.serve_buckets) != sorted(set(self.serve_buckets)):
            raise ValueError(f"serve_buckets must be strictly increasing, "
                             f"got {self.serve_buckets}")

    def replace(self, **overrides) -> "EngineConfig":
        """A copy with the given fields replaced (validation re-runs)."""
        return dataclasses.replace(self, **overrides)

    def bucket_ladder(self) -> tuple:
        """The ascending dispatch sizes serving may pad a micro-batch to:
        ``serve_buckets`` plus the full ``serve_batch_size`` as the top
        rung. With no buckets configured this is the single-size ladder
        ``(serve_batch_size,)`` — the pre-bucketing contract."""
        return tuple(b for b in self.serve_buckets
                     if b < self.serve_batch_size) + (self.serve_batch_size,)

    def build_kwargs(self) -> dict:
        """Kwargs for core/sah.py::build (index construction)."""
        return dict(k_max=self.k_max, n_top=self.n_top,
                    leaf_size=self.leaf_size, b=self.b, n_bits=self.n_bits,
                    tile=self.tile, max_partitions=self.max_partitions,
                    transform=self.transform, blocking=self.blocking)

    def query_kwargs(self) -> dict:
        """Kwargs for core/sah.py::rkmips / rkmips_batch."""
        return dict(scan=self.scan, n_cand=self.n_cand, chunk=self.chunk,
                    tie_eps=self.tie_eps,
                    scan_precision=self.scan_precision)

    def kmips_build_kwargs(self, n_items: int) -> dict:
        """Kwargs for core/sa_alsh.py::build_index over ``n_items`` rows.

        The single source of truth for the kMIPS/serving index recipe: the
        engine's kMIPS index, ``build_serving_state``, ``serving_codes``
        and the ``ServingCache`` key all derive from it, so a new build
        knob threads through every builder *and* the cache key at once —
        a stale key can't serve wrong codes as a "hit". The tile is
        clamped to the corpus so every path builds identical shapes.
        """
        return dict(b=self.b, n_bits=self.n_bits,
                    tile=min(self.tile, n_items),
                    max_partitions=self.max_partitions,
                    transform=self.transform)


# ---------------------------------------------------------------------------
# Method registry.
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, EngineConfig] = {}
_DISPLAY: dict[str, str] = {}


def register(name: str, config: EngineConfig, *,
             display: str | None = None) -> None:
    """Register a named preset. Names are case-insensitive; re-registering
    an existing name replaces it (configs are values, not identities)."""
    key = name.lower()
    _REGISTRY[key] = config
    _DISPLAY[key] = display if display is not None else name


def get_config(name: str) -> EngineConfig:
    """The preset registered under ``name`` (case-insensitive)."""
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(f"unknown engine method {name!r}; known: "
                       f"{', '.join(sorted(_REGISTRY))}") from None


def method_names() -> tuple[str, ...]:
    """All registered method names, registration order."""
    return tuple(_REGISTRY)


def display_name(name: str) -> str:
    """The paper-style display name ("sah" -> "SAH")."""
    get_config(name)   # raise on unknown
    return _DISPLAY[name.lower()]


register("sah", EngineConfig(), display="SAH")
register("sa-simpfer", EngineConfig(blocking="norm"), display="SA-Simpfer")
register("h2-cone", EngineConfig(transform="qnf"), display="H2-Cone")
register("h2-simpfer", EngineConfig(transform="qnf", blocking="norm"),
         display="H2-Simpfer")
register("simpfer", EngineConfig(blocking="norm", scan="exact"),
         display="Simpfer")
register("exact", EngineConfig(scan="exact"), display="Exact")

# The paper's Fig.1/Fig.2 comparison grid (DESIGN.md SS3). "exact" is the
# in-engine oracle configuration, not a benchmarked baseline.
PAPER_BASELINES: tuple[str, ...] = ("sah", "sa-simpfer", "h2-cone",
                                    "h2-simpfer", "simpfer")

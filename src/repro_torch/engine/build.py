"""The SAH index build as staged stages, timed and mesh-parallel (port
of ``src/repro/engine/build.py``, DESIGN.md SS11).

``core/sah.py::build`` composes four stages (Algorithm 4):

  1. norm_split     -- item norm-sort + top-n_top split
  2. item_codes     -- SA-ALSH partitions, transform and SRP codes
  3. user_blocking  -- cone-tree or "norm" blocking of the users
  4. lower_bounds   -- Simpfer L_u / L_B over P'

``build_sah_index`` composes the same stage functions in the same order,
so its index is bitwise ``sah.build``'s, and records each stage's wall
time (``BuildTimings``), syncing the device at each stage boundary. It
also takes a ready-made stage 3 output: ``IndexArtifact.compact`` keeps
the users and their blocking and rebuilds only the item side and the
bounds.

Stage 2's SRP hashing is independent per item row and stage 4's lower
bounds per user row, so both run row-parallel (``row_parallel``): under
a mesh policy each rank computes its slice of the zero-padded rows and an
all-gather in mesh order reassembles them. A row's result does not depend
on the rows that share its call (the SRP kernel's own running sum per
row; the bounds by fixed-shape row chunks, ``core/rows.py``), so:

  **invariant: the sharded build on any mesh gives the single-device
  index bit for bit** (tests/test_torch_dist.py, also at the
  reference's own failing case, n=97, m=7 over 8 shards).

The sequential stages (sort, partitions, cone tree) run whole on every
rank. ``EngineConfig.build_sharding`` selects: "auto" shards under a mesh
of more than one rank, "single" never, "sharded" requires a mesh (or the
seam). ``shards`` is the mesh-free seam: per-slice compute and concatenate
in one process, so single-process tests hold the invariant for any shard
count.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from repro_torch.core import sa_alsh as _alsh
from repro_torch.core import sah as _sah
from repro_torch.core import simpfer as _simpfer
from repro_torch.dist import collectives as _coll
from repro_torch.dist.policy import NO_SHARDING, ShardingPolicy, shard_rank
from repro_torch.engine.config import EngineConfig
from repro_torch.kernels import ops as kops

BUILD_SHARDING_MODES = ("auto", "single", "sharded")


class BuildTimings(NamedTuple):
    """Wall seconds per build stage (kernel builds included on a first
    build in the process)."""

    norm_split: float      # stage 1: item sort + top-n_top split
    item_codes: float      # stage 2: SA-ALSH partitions/transform/codes
    user_blocking: float   # stage 3: cone / norm blocking of users
    lower_bounds: float    # stage 4: Simpfer L_u / L_B over P'
    sharded: bool          # whether stages 2b/4 ran row-parallel

    @property
    def total(self) -> float:
        return (self.norm_split + self.item_codes + self.user_blocking
                + self.lower_bounds)

    def format(self) -> str:
        """One human-readable breakdown line."""
        mode = "sharded" if self.sharded else "single-device"
        return (f"build {self.total * 1e3:.1f} ms ({mode}): "
                f"norm-split {self.norm_split * 1e3:.1f} | "
                f"item-codes {self.item_codes * 1e3:.1f} | "
                f"user-blocking {self.user_blocking * 1e3:.1f} | "
                f"lower-bounds {self.lower_bounds * 1e3:.1f}")


def validate_build_knobs(config: EngineConfig) -> None:
    """Reject unusable build knobs before any work is done (a config can
    reach a build without its ``__post_init__`` re-running)."""
    for name in ("k_max", "leaf_size", "n_bits", "tile", "max_partitions"):
        v = getattr(config, name)
        if not isinstance(v, int) or isinstance(v, bool) or v < 1:
            raise ValueError(f"build knob {name} must be a positive int, "
                             f"got {v!r}")
    if config.n_bits % 32 != 0:
        raise ValueError(f"build knob n_bits must be a multiple of 32, "
                         f"got {config.n_bits}")
    if config.n_top is not None and config.n_top < config.k_max:
        raise ValueError(f"build knob n_top ({config.n_top}) must be >= "
                         f"k_max ({config.k_max})")
    if getattr(config, "build_sharding", "auto") not in BUILD_SHARDING_MODES:
        raise ValueError(f"build_sharding must be one of "
                         f"{BUILD_SHARDING_MODES}, "
                         f"got {config.build_sharding!r}")


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _want_sharded(config: EngineConfig, policy: ShardingPolicy,
                  shards: int | None) -> bool:
    """Whether the row-parallel stages shard (``build.py:110-131``)."""
    mode = config.build_sharding
    have = policy.device_count > 1 or (shards is not None and shards > 1)
    if mode == "single":
        return False
    if mode == "sharded":
        if not have:
            raise ValueError(
                "build_sharding='sharded' requires a multi-rank mesh policy "
                "(or the `shards` testing seam); pass a mesh ShardingPolicy "
                "or use build_sharding='auto'")
        return True
    return have


def _pad_rows_zero(rows: torch.Tensor, n_pad: int) -> torch.Tensor:
    if n_pad == rows.shape[0]:
        return rows
    return torch.cat([rows, rows.new_zeros(
        (n_pad - rows.shape[0],) + tuple(rows.shape[1:]))])


def row_parallel(fn, rows: torch.Tensor, consts: tuple = (), *,
                 policy: ShardingPolicy = NO_SHARDING,
                 shards: int | None = None) -> torch.Tensor:
    """Run a per-row function over row shards; bitwise ``fn(rows, ...)``
    (``build.py:134-178``).

    ``fn(rows_slice, *consts) -> (r, ...)`` must be independent per row.
    Rows are padded with dead zero rows to the next shard multiple and the
    padding is cut from the result. Under a mesh policy this rank computes
    its slice (a fresh tensor) and one all-gather, in mesh order, gives
    every rank the whole result; with ``shards`` the slices run one after
    another in this process; otherwise ``fn`` runs once."""
    n = rows.shape[0]
    if policy.mesh is not None and policy.device_count > 1:
        _coll.check_mesh(policy)
        s = policy.device_count
        per = -(-n // s)
        lo = shard_rank(policy) * per
        part = _pad_rows_zero(rows, per * s)[lo:lo + per].clone()
        return _coll.all_gather_cat(fn(part, *consts), policy)[:n]
    if shards is not None and shards > 1:
        per = -(-n // shards)
        padded = _pad_rows_zero(rows, per * shards)
        return torch.cat([fn(padded[i * per:(i + 1) * per].clone(), *consts)
                          for i in range(shards)])[:n]
    return fn(rows, *consts)


def build_sah_index(items: torch.Tensor, users: torch.Tensor,
                    generator: torch.Generator | None = None, *,
                    config: EngineConfig,
                    proj: torch.Tensor | None = None,
                    cone_order: torch.Tensor | None = None,
                    blocking: _sah.UserBlocking | None = None,
                    policy: ShardingPolicy = NO_SHARDING,
                    shards: int | None = None
                    ) -> tuple[_sah.SAHIndex, BuildTimings]:
    """Algorithm 4 as the staged pipeline: (SAHIndex, BuildTimings),
    bitwise ``sah.build(items, users, ..., **config.build_kwargs())``, and
    bitwise the same under any ``policy`` mesh or ``shards`` seam (module
    docstring); every rank of a mesh gets the whole, mesh-agnostic index.

    ``proj`` and ``cone_order`` inject the two random draws, as in
    ``sah.build``; whatever is not injected comes from ``generator``, the
    projection first. ``blocking`` replaces stage 3 with a ready-made
    blocking of ``users`` (then no permutation is drawn).
    """
    validate_build_knobs(config)
    sharded = _want_sharded(config, policy, shards)
    hash_rows = lb_rows = None
    if sharded:
        def hash_rows(rows, p):
            return row_parallel(kops.srp_hash, rows, (p,), policy=policy,
                                shards=shards)

        def lb_rows(rows, top, kmax):
            return row_parallel(
                lambda r, t: _simpfer.user_lower_bounds(r, t, kmax), rows,
                (top,), policy=policy, shards=shards)
    n_top = 2 * config.k_max if config.n_top is None else config.n_top

    t0 = time.perf_counter()
    split = _sah.split_items_by_norm(items, n_top)
    _sync(split.rest)
    t1 = time.perf_counter()

    alsh = _alsh.build_index(split.rest, generator, proj=proj, b=config.b,
                             n_bits=config.n_bits, tile=config.tile,
                             max_partitions=config.max_partitions,
                             transform=config.transform, hash_rows=hash_rows)
    alsh = _sah.shift_item_ids(alsh, split.order, n_top)
    _sync(alsh.codes)
    t2 = time.perf_counter()

    if blocking is None:
        blocking = _sah.block_users(users, generator=generator,
                                    cone_order=cone_order,
                                    leaf_size=config.leaf_size,
                                    blocking=config.blocking)
    _sync(blocking.users)
    t3 = time.perf_counter()

    lb, block_lb = _sah.lower_bounds(blocking.users, blocking.user_mask,
                                     split.top_items, config.k_max,
                                     blocking.center.shape[0],
                                     lb_rows=lb_rows)
    _sync(lb)
    t4 = time.perf_counter()

    index = _sah.SAHIndex(alsh=alsh, users=blocking.users,
                          user_ids=blocking.user_ids,
                          user_mask=blocking.user_mask,
                          center=blocking.center, omega=blocking.omega,
                          theta=blocking.theta, user_lb=lb,
                          block_lb=block_lb, top_norms=split.top_norms,
                          top_items=split.top_items, top_ids=split.top_ids)
    return index, BuildTimings(norm_split=t1 - t0, item_codes=t2 - t1,
                               user_blocking=t3 - t2, lower_bounds=t4 - t3,
                               sharded=sharded)

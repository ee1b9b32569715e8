"""IndexArtifact: the build / save / load / delta lifecycle of a SAH index
(port of ``src/repro/engine/artifact.py:137-752``, DESIGN.md §10; the
port's restatement is PORT.md, "Index artifacts").

An artifact is a value: the SAH user index, the (lazily built) forward
kMIPS index, the build key, the source arrays, a staged-insert delta
buffer and a content fingerprint. ``insert_items``, ``delete_items`` and
``compact`` return a new version and leave their parent as it was.

  * ``save(dir)`` / ``load(dir)`` write and read the reference's layout
    (``train/checkpoint.py``: an npz and a fsynced manifest), under the
    reference's leaf names, with the SRP codes as uint32; ``load``
    re-hashes the content against the manifest's fingerprint. Each
    package loads what the other saved.
  * The fingerprint hashes what the reference's does, byte for byte: the
    config's ``repr`` with its execution-only knobs reset, then
    dtype + shape + bytes of ``key``, ``items`` and ``users``, then the
    delta state. Equal content gives equal fingerprints in both packages.
  * ``key`` is a uint32 (2,) array, the reference's raw key. Torch cannot
    replay ``jax.random``, so in the port the key is a tag of the build's
    draws, not their source: a port build draws it from the generator
    ahead of its draws, or takes it as given; the forward index's
    projection is kept beside it (``kmips_proj``), where the reference
    derives it from ``fold_in(key, 0x5A11)``.
  * ``compact`` folds the staged changes into a fresh build over the
    effective corpus with the draws the artifact holds (the item-side
    projection, the user blocking, the forward projection): the
    reference's compact redraws exactly these from the same key, since
    their shapes do not depend on the items.

Delta-view invariants (``query_view``): the view keeps every shape of the
base index; deleted rest rows leave ``alsh.item_mask``; ``user_lb`` and
``block_lb`` are recomputed over P' minus its deleted members;
``top_norms`` is the top-n_top of the live norms of P', of the rest and of
the staged rows; live staged rows are counted exactly into every lane.
Every shortcut stays conservative, so under ``scan="exact"`` the
pre-compact answers equal a from-scratch build's on the effective corpus.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable

import numpy as np
import torch

from repro_torch.core import sa_alsh as _alsh
from repro_torch.core import sah as _sah
from repro_torch.core import srp as _srp
from repro_torch.dist.policy import NO_SHARDING, ShardingPolicy
from repro_torch.engine import build as _build
from repro_torch.engine.config import EngineConfig, get_config
from repro_torch.train import checkpoint as _ckpt

_FORMAT = 1
_KIND = "sah-index-artifact"
# config knobs no built array depends on (``IndexArtifact.with_config``)
_RECONFIGURABLE = ("build_sharding", "scan_precision", "scan_budget",
                   "serve_batch_size", "serve_buckets",
                   "serve_cache_capacity")


def device_of(device, who: str) -> torch.device:
    """``device`` as a ``torch.device`` with its index; None means
    "cuda", which raises when there is no CUDA device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on a CUDA device by default and none is "
            f"available; pass device='cpu' to run the plain PyTorch path")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def as_rows(x, name: str, device: torch.device) -> torch.Tensor:
    """A non-empty floating 2-D array as a contiguous float32 tensor on
    ``device``; a clear ``ValueError`` otherwise."""
    t = torch.as_tensor(x)
    if t.dim() != 2 or t.shape[0] < 1:
        raise ValueError(f"{name} must be a non-empty 2-D (rows, d) array, "
                         f"got shape {tuple(t.shape)}")
    if not t.is_floating_point():
        raise ValueError(f"{name} must have a floating dtype, got {t.dtype}")
    return t.to(device=device, dtype=torch.float32).contiguous()


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _array_bytes(x) -> bytes:
    a = _host(x)
    return (str(a.dtype).encode() + str(a.shape).encode()
            + np.ascontiguousarray(a).tobytes())


def corpus_fingerprint(items, key) -> str:
    """Content hash of a raw corpus and its key (``artifact.py:76-85``)."""
    h = hashlib.sha256(b"repro-corpus-v1")
    h.update(_array_bytes(items))
    h.update(_array_bytes(as_key(key)))
    return h.hexdigest()


def as_key(key) -> np.ndarray:
    """The build key as the reference's raw key: a uint32 (2,) array."""
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype.kind not in "iu" or (
            k.astype(np.int64) != k.astype(np.uint32).astype(np.int64)).any():
        raise ValueError(f"key must be two uint32 words (the reference's raw "
                         f"key), got {k.dtype} {k.shape}")
    return k.astype(np.uint32)


def draw_key(generator: torch.Generator) -> np.ndarray:
    """A uint32 (2,) key drawn from ``generator``: the tag of a port
    build's draws."""
    return torch.randint(0, 2 ** 32, (2,), generator=generator,
                         dtype=torch.int64).numpy().astype(np.uint32)


def _flatten_named(prefix: str, nt, out: dict) -> None:
    """NamedTuple fields as numpy leaves named ``prefix/field`` (nested
    tuples recurse); the SRP codes go as the reference's uint32."""
    for name, v in zip(type(nt)._fields, nt):
        if hasattr(v, "_fields"):
            _flatten_named(f"{prefix}{name}/", v, out)
        else:
            a = _host(v)
            out[f"{prefix}{name}"] = a.view(np.uint32) if name == "codes" \
                else a


class IndexArtifact:
    """One immutable version of a built SAH index and its corpus deltas.

    Make one with ``IndexArtifact.build`` or ``load``; the constructor
    wires built pieces together. ``fingerprint`` identifies a version's
    whole content (corpus, users, key, config, staged deltas). Every
    tensor lives on one device, ``self.device``.
    """

    def __init__(self, *, config: EngineConfig, key,
                 items: torch.Tensor, users: torch.Tensor | None,
                 index: _sah.SAHIndex | None,
                 kmips_index: _alsh.SAALSHIndex | None,
                 deleted: torch.Tensor, delta_items: torch.Tensor,
                 delta_mask: torch.Tensor, delta_used: int,
                 kmips_proj: torch.Tensor | None = None):
        if kmips_index is None and kmips_proj is None:
            raise ValueError("an artifact needs its forward index or the "
                             "forward projection kmips_proj")
        self.config = config
        self.key = as_key(key)
        self.items = items                  # (n_base, d) corpus at build
        self.users = users                  # (m, d) or None (kMIPS-only)
        self.index = index                  # SAHIndex or None
        self.deleted = deleted              # (n_base,) bool
        self.delta_items = delta_items      # (capacity, d) staged rows
        self.delta_mask = delta_mask        # (capacity,) bool live rows
        self.delta_used = int(delta_used)   # slots consumed (append-only)
        # BuildTimings of the build that made this version; None when
        # loaded or wired from pieces; never hashed or saved
        self.build_timings = None
        self._kmips = kmips_index
        self._kmips_proj = kmips_proj if kmips_index is None \
            else kmips_index.proj
        self._kmips_view = None
        self._base_fp: str | None = None
        self._fingerprint: str | None = None
        self._users_unit = None

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, items, users, generator: torch.Generator | None = None,
              *, config: EngineConfig | str = "sah",
              delta_capacity: int | None = None, key=None, proj=None,
              cone_order=None, blocking: _sah.UserBlocking | None = None,
              kmips_proj=None, device=None,
              policy: ShardingPolicy = NO_SHARDING) -> "IndexArtifact":
        """Build a fresh artifact through the staged pipeline
        (``engine/build.py``). items (n, d), users (m, d) or None, on
        ``device`` (None means "cuda").

        The random inputs come from ``generator`` (a CPU generator, seeded
        0 when None) in this order, each unless given: the key, the
        item-side projection ``proj`` and the cone permutation
        ``cone_order`` (``sah.build``), then the forward projection
        ``kmips_proj``. ``blocking`` is a ready-made user blocking (stage
        3's output), as ``compact`` passes. ``users=None`` builds only the
        forward index, at once; with users it is built at first use.
        ``delta_capacity`` (default ``config.delta_capacity``) sizes the
        staged-insert buffer. ``policy``: run the build's row-parallel
        stages over its mesh (every rank calls, with the same inputs and
        draws); the artifact is bitwise the single-device one, whole on
        every rank.
        """
        if isinstance(config, str):
            config = get_config(config)
        dev = device_of(device, "IndexArtifact")
        items = as_rows(items, "items", dev)
        n, d = items.shape
        if users is not None:
            users = as_rows(users, "users", dev)
            if users.shape[1] != d:
                raise ValueError(f"users dimensionality ({users.shape[1]}) "
                                 f"!= items dimensionality ({d})")
        _build.validate_build_knobs(config)
        cap = config.delta_capacity if delta_capacity is None \
            else int(delta_capacity)
        if cap < 1:
            raise ValueError(f"delta_capacity must be >= 1, got {cap}")
        if proj is not None:
            proj = as_rows(proj, "proj", dev)
        if kmips_proj is not None:
            kmips_proj = as_rows(kmips_proj, "kmips_proj", dev)
        want = (d + 1, config.n_bits)
        for name, p in (("proj", proj), ("kmips_proj", kmips_proj)):
            if p is not None and tuple(p.shape) != want:
                raise ValueError(f"{name} must be (d+1, n_bits) = {want}, "
                                 f"got {tuple(p.shape)}")
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        key = draw_key(generator) if key is None else key
        if cone_order is not None:
            cone_order = torch.as_tensor(cone_order).to(torch.int64)
        index = kmips = timings = None
        if users is not None:
            index, timings = _build.build_sah_index(
                items, users, generator, config=config, proj=proj,
                cone_order=cone_order, blocking=blocking, policy=policy)
        if kmips_proj is None:
            kmips_proj = _srp.make_projection(generator, d + 1,
                                              config.n_bits, dev)
        if users is None:
            kmips = _alsh.build_index(items, proj=kmips_proj,
                                      **config.kmips_build_kwargs(n))
        art = cls(config=config, key=key, items=items, users=users,
                  index=index, kmips_index=kmips,
                  deleted=torch.zeros(n, dtype=torch.bool, device=dev),
                  delta_items=torch.zeros(cap, d, device=dev),
                  delta_mask=torch.zeros(cap, dtype=torch.bool, device=dev),
                  delta_used=0, kmips_proj=kmips_proj)
        art.build_timings = timings
        return art

    def _evolve(self, **overrides) -> "IndexArtifact":
        kw = dict(config=self.config, key=self.key, items=self.items,
                  users=self.users, index=self.index,
                  kmips_index=self._kmips, deleted=self.deleted,
                  delta_items=self.delta_items, delta_mask=self.delta_mask,
                  delta_used=self.delta_used, kmips_proj=self._kmips_proj)
        kw.update(overrides)
        child = IndexArtifact(**kw)
        # a delta mutation never touches the base: the child keeps its
        # O(n*d) hash and the unit users, and hashes only its delta state
        child._base_fp = self._base_fp
        child._users_unit = self._users_unit
        child.build_timings = self.build_timings
        return child

    def with_config(self, config: EngineConfig) -> "IndexArtifact":
        """This version under ``config``, which may differ from its own
        only in knobs no built array depends on: the execution-only ones
        ``RkMIPSEngine.attach`` ignores and the ``serve_*`` ones. The
        built pieces are shared, not copied; the fingerprint follows the
        config, which it hashes."""
        if config.replace(**{f: getattr(self.config, f)
                             for f in _RECONFIGURABLE}) != self.config:
            raise ValueError(
                f"with_config changes only {', '.join(_RECONFIGURABLE)}; "
                f"any other knob needs a rebuild")
        child = self._evolve(config=config)
        child._base_fp = None
        return child

    # -- identity ----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.items.device

    @property
    def delta_capacity(self) -> int:
        return self.delta_items.shape[0]

    @property
    def n_base(self) -> int:
        """Rows of the base (last-compacted) corpus."""
        return self.items.shape[0]

    @property
    def n_users(self) -> int | None:
        return None if self.users is None else self.users.shape[0]

    @property
    def n_items(self) -> int:
        """Rows of the effective (mutated) corpus."""
        return (self.n_base - int(self.deleted.sum())
                + int(self.delta_mask.sum()))

    @property
    def has_pending(self) -> bool:
        """Any staged change (a delete or a live insert) not compacted."""
        return bool(self.deleted.any()) or bool(self.delta_mask.any())

    @property
    def kmips_index(self) -> _alsh.SAALSHIndex | None:
        """The base corpus's forward index if already built."""
        return self._kmips

    @property
    def kmips_proj(self) -> torch.Tensor:
        """The forward index's (d+1, n_bits) projection, built or not."""
        return self._kmips_proj

    @property
    def fingerprint(self) -> str:
        """Content hash of this version (``artifact.py:279-318``): the
        base hash (config repr, key, items, users) is computed once per
        build and inherited across delta mutations, then the delta state
        (deleted, delta_items, delta_mask, delta_used) is hashed on it."""
        if self._fingerprint is None:
            if self._base_fp is None:
                b = hashlib.sha256(f"{_KIND}-v{_FORMAT}".encode())
                # execution-only knobs: the built content is the same
                # under every value, so they must not move the hash
                cfg = self.config.replace(build_sharding="auto",
                                          scan_precision="f32",
                                          scan_budget=0)
                b.update(repr(dataclasses.astuple(cfg)).encode())
                b.update(_array_bytes(self.key))
                b.update(_array_bytes(self.items))
                b.update(b"users" if self.users is None
                         else _array_bytes(self.users))
                self._base_fp = b.hexdigest()
            h = hashlib.sha256(self._base_fp.encode())
            h.update(_array_bytes(self.deleted))
            h.update(_array_bytes(self.delta_items))
            h.update(_array_bytes(self.delta_mask))
            h.update(str(self.delta_used).encode())
            self._fingerprint = h.hexdigest()
        return self._fingerprint

    @property
    def base_fingerprint(self) -> str:
        """Content hash of the built base only, shared by every
        delta-descendant of one build."""
        if self._base_fp is None:
            self.fingerprint  # computes and memoizes _base_fp
        return self._base_fp

    @property
    def manifest(self) -> dict:
        """The JSON description ``save`` writes and ``load`` checks."""
        return {
            "kind": _KIND,
            "format": _FORMAT,
            "fingerprint": self.fingerprint,
            "config": dataclasses.asdict(self.config),
            "n_base": self.n_base,
            "n_users": self.n_users,
            "n_items": self.n_items,
            "delta_capacity": self.delta_capacity,
            "delta_used": self.delta_used,
            "has_index": self.index is not None,
            "has_kmips": self._kmips is not None,
        }

    # -- derived views -----------------------------------------------------

    def users_unit(self) -> torch.Tensor | None:
        if self.users is None:
            return None
        if self._users_unit is None:
            self._users_unit = _sah.unit_rows(self.users)
        return self._users_unit

    def effective_items(self) -> torch.Tensor:
        """The mutated corpus in compaction order: surviving base rows in
        original order, then live staged rows in slot order."""
        if not self.has_pending:
            return self.items
        return torch.cat([self.items[~self.deleted],
                          self.delta_items[self.delta_mask]])

    def effective_ids(self) -> np.ndarray:
        """Item id of each ``effective_items()`` row (int32): base rows
        keep their ids, staged slot j is ``n_base + j``."""
        if not self.has_pending:
            return np.arange(self.n_base, dtype=np.int32)
        base = np.where(~_host(self.deleted))[0]
        slots = np.where(_host(self.delta_mask))[0]
        return np.concatenate([base, self.n_base + slots]).astype(np.int32)

    def ensure_kmips_index(self) -> _alsh.SAALSHIndex:
        """The base corpus's forward index, built at first use from
        ``kmips_proj`` and memoized."""
        if self._kmips is None:
            self._kmips = _alsh.build_index(
                self.items, proj=self._kmips_proj,
                **self.config.kmips_build_kwargs(self.n_base))
        return self._kmips

    def kmips_delta(self):
        """``(delta_items, delta_mask)`` when any staged row is live, else
        ``(None, None)``: the one delta-liveness rule."""
        if bool(self.delta_mask.any()):
            return self.delta_items, self.delta_mask
        return None, None

    def _dead(self, ids: torch.Tensor) -> torch.Tensor:
        """Whether each item id (-1 padding) is deleted."""
        return torch.where(ids >= 0,
                           self.deleted[torch.clamp(ids, min=0).long()],
                           False)

    def kmips_query_view(self) -> _alsh.SAALSHIndex:
        """The forward index with deleted rows masked out of the scan
        (same shapes as the base index)."""
        if self._kmips_view is None:
            idx = self.ensure_kmips_index()
            self._kmips_view = idx
            if bool(self.deleted.any()):
                self._kmips_view = idx._replace(
                    item_mask=idx.item_mask & ~self._dead(idx.item_ids))
        return self._kmips_view

    def query_view(self):
        """``(SAHIndex view, delta_items | None, delta_mask | None)``:
        what an attached engine answers reverse queries against
        (``artifact.py:429-486``; the invariants are in the module
        docstring). Without pending changes, the base index itself; with
        deletions only, no delta buffer."""
        if self.index is None:
            raise RuntimeError("artifact has no user-side index: built "
                               "with users=None (kMIPS-only)")
        if not self.has_pending:
            return self.index, None, None
        idx = self.index
        alsh_mask, top_alive = idx.alsh.item_mask, idx.top_norms
        user_lb, block_lb = idx.user_lb, idx.block_lb
        if bool(self.deleted.any()):
            del_top = self.deleted[idx.top_ids.long()]
            alsh_mask = alsh_mask & ~self._dead(idx.alsh.item_ids)
            top_alive = torch.where(del_top, float("-inf"), top_alive)
            if bool(del_top.any()):
                # the bounds over P' without its deleted members (with
                # fewer than k_max left, the tail is -inf); otherwise the
                # stored bounds are already what this would give
                user_lb, block_lb = _sah.lower_bounds(
                    idx.users, idx.user_mask, idx.top_items, idx.kmax,
                    idx.n_blocks, mask=~del_top)
        delta_norms = torch.where(self.delta_mask,
                                  torch.linalg.norm(self.delta_items, dim=-1),
                                  float("-inf"))
        merged = torch.cat([top_alive,
                            torch.where(alsh_mask, idx.alsh.norms,
                                        float("-inf")),
                            delta_norms])
        top_norms = torch.topk(merged, idx.top_norms.shape[0]).values
        view = idx._replace(alsh=idx.alsh._replace(item_mask=alsh_mask),
                            user_lb=user_lb, block_lb=block_lb,
                            top_norms=top_norms)
        return (view,) + self.kmips_delta()

    # -- streaming corpus deltas -------------------------------------------

    def insert_items(self, rows) -> "IndexArtifact":
        """Stage new corpus rows; returns the new version. Rows take the
        next free slots of the buffer (append-only until ``compact``) and
        the ids ``n_base + slot``. Raises ``ValueError`` when they do not
        fit."""
        rows = torch.as_tensor(rows)
        if rows.dim() == 1:
            rows = rows[None]
        d = self.items.shape[1]
        if rows.dim() != 2 or rows.shape[1] != d:
            raise ValueError(f"rows must be (r, {d}) to match the corpus, "
                             f"got shape {tuple(rows.shape)}")
        if not rows.is_floating_point():
            raise ValueError(f"rows must have a floating dtype, got "
                             f"{str(rows.dtype).removeprefix('torch.')}")
        r = rows.shape[0]
        free = self.delta_capacity - self.delta_used
        if r > free:
            raise ValueError(
                f"delta buffer full: {r} rows do not fit in the "
                f"{free} free of {self.delta_capacity} slots "
                f"({self.delta_used} used); call compact() first")
        lo, hi = self.delta_used, self.delta_used + r
        delta_items = self.delta_items.clone()
        delta_items[lo:hi] = rows.to(self.delta_items)
        delta_mask = self.delta_mask.clone()
        delta_mask[lo:hi] = True
        return self._evolve(delta_items=delta_items, delta_mask=delta_mask,
                            delta_used=hi)

    def delete_items(self, ids: Iterable[int]) -> "IndexArtifact":
        """Retire rows by id; returns the new version. Ids below
        ``n_base`` address the base corpus, ids in ``[n_base, n_base +
        delta_used)`` staged rows. Idempotent per id; an id out of range
        raises ``ValueError``."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        hi = self.n_base + self.delta_used
        if ids.size and (ids.min() < 0 or ids.max() >= hi):
            raise ValueError(f"item ids must be in [0, {hi}) "
                             f"({self.n_base} base rows + {self.delta_used} "
                             f"staged), got {ids[(ids < 0) | (ids >= hi)]}")
        dev = self.device
        deleted = self.deleted.clone()
        deleted[torch.as_tensor(ids[ids < self.n_base], device=dev)] = True
        delta_mask = self.delta_mask.clone()
        delta_mask[torch.as_tensor(ids[ids >= self.n_base] - self.n_base,
                                   device=dev)] = False
        return self._evolve(deleted=deleted, delta_mask=delta_mask)

    def compact(self, *, policy: ShardingPolicy = NO_SHARDING
                ) -> "IndexArtifact":
        """Fold every staged change into a fresh build over the effective
        corpus, with an empty buffer of the same capacity. Returns self
        when nothing is staged.

        The reference rebuilds from scratch with the same key; its draws
        depend only on shapes a compaction keeps (the (d+1, n_bits)
        projections and the cone permutation over m_pad users), so it
        redraws exactly what this artifact holds. This reuses them: the
        item-side and forward projections and the stored user blocking;
        the norm split, the item codes and the Simpfer bounds are
        recomputed, row-parallel over ``policy``'s mesh when it has one
        (the same artifact bit for bit).
        """
        if self.delta_used == 0 and not bool(self.deleted.any()):
            return self
        proj = blocking = None
        if self.index is not None:
            idx = self.index
            proj = idx.alsh.proj
            blocking = _sah.UserBlocking(
                users=idx.users, user_ids=idx.user_ids,
                user_mask=idx.user_mask, center=idx.center,
                omega=idx.omega, theta=idx.theta)
        return IndexArtifact.build(
            self.effective_items(), self.users, config=self.config,
            delta_capacity=self.delta_capacity, key=self.key, proj=proj,
            blocking=blocking, kmips_proj=self.kmips_proj,
            device=self.device, policy=policy)

    # -- serving surface ---------------------------------------------------

    def serving_corpus(self):
        """``(effective items, forward projection, fingerprint)``: the
        mutated corpus and this version's hash. The projection stands
        where the reference returns its derived serving key."""
        return self.effective_items(), self.kmips_proj, self.fingerprint

    def serving_base(self):
        """``(base items, forward projection, base fingerprint)``: what a
        forward server binds, with the deltas as an overlay."""
        return self.items, self.kmips_proj, self.base_fingerprint

    def serving_codes(self) -> tuple[torch.Tensor, torch.Tensor]:
        """``(codes (n_base, W) int32, proj_q (d, n_bits))``: each base
        row's forward SRP code in input row order, and the query-side
        projection."""
        idx = self.ensure_kmips_index()
        codes = torch.zeros(self.n_base, idx.codes.shape[1],
                            dtype=idx.codes.dtype, device=self.device)
        live = idx.item_ids >= 0
        codes[idx.item_ids[live].long()] = idx.codes[live]
        return codes, idx.proj[:-1]

    # -- persistence -------------------------------------------------------

    def _flat_arrays(self) -> dict:
        out = {name: _host(getattr(self, name)) for name in (
            "items", "key", "deleted", "delta_items", "delta_mask")}
        # the buffer's int8 twin travels as in the reference's layout;
        # no port path reads it (both loaders recompute it)
        out["delta_qitems"], out["delta_qscale"] = map(
            _host, _alsh.quantize_rows(self.delta_items))
        if self.users is not None:
            out["users"] = _host(self.users)
        if self.index is not None:
            _flatten_named("index/", self.index, out)
        if self._kmips is not None:
            _flatten_named("kmips/", self._kmips, out)
        return out

    def save(self, artifact_dir: str, *, step: int = 0,
             keep: int | None = None) -> str:
        """Persist this version under ``artifact_dir`` (atomic: npz +
        fsynced manifest). The forward index is built first, so its
        projection always travels with the artifact. ``keep=N`` then
        prunes the directory to its N newest steps, never the one just
        saved. Returns the checkpoint path."""
        if keep is not None and keep < 1:
            raise ValueError(f"keep must be >= 1 (the saved version always "
                             f"survives), got {keep}")
        self.ensure_kmips_index()
        path = _ckpt.save(artifact_dir, step, self._flat_arrays(),
                          metadata=self.manifest)
        if keep is not None:
            _ckpt.prune(artifact_dir, keep, protect=(step,))
        return path

    @classmethod
    def load(cls, artifact_dir: str, *, step: int | None = None,
             device=None, kmips_proj=None) -> "IndexArtifact":
        """Restore the newest (or the given) saved version onto ``device``
        (None means "cuda") and check its recomputed fingerprint against
        the manifest's. An artifact saved without its forward index
        (``kmips/`` arrays, as the reference saves one whose forward index
        was never built) needs ``kmips_proj``, the (d+1, n_bits) forward
        projection: the port cannot derive it from the key."""
        dev = device_of(device, "IndexArtifact.load")
        if step is None:
            step = _ckpt.latest_step(artifact_dir)
            if step is None:
                raise FileNotFoundError(
                    f"no saved index artifact under {artifact_dir!r}")
        manifest = _ckpt.read_manifest(artifact_dir, step)
        meta = manifest["metadata"]
        if meta.get("kind") != _KIND:
            raise ValueError(f"{artifact_dir!r} step {step} is not an index "
                             f"artifact (kind={meta.get('kind')!r})")
        if meta.get("format", 0) > _FORMAT:
            raise ValueError(f"artifact format {meta['format']} is newer "
                             f"than this build supports ({_FORMAT})")
        if not meta["has_kmips"] and kmips_proj is None:
            raise ValueError(
                f"{artifact_dir!r} step {step} holds no forward index "
                f"(kmips/ arrays) and the port cannot derive its "
                f"projection from the key (the reference draws it from "
                f"fold_in(key, 0x5A11)); pass kmips_proj, the (d+1, "
                f"n_bits) forward projection")
        like = {k: np.empty(v["shape"], np.dtype(v["dtype"]))
                for k, v in manifest["index"].items()}
        tree, _ = _ckpt.restore(artifact_dir, step, like)

        def t(name):
            return _sah._tensor(tree, name, dev)

        art = cls(
            config=EngineConfig(**meta["config"]), key=tree["key"],
            items=t("items"), users=t("users") if "users" in tree else None,
            index=(_sah.index_from_numpy(tree, dev) if meta["has_index"]
                   else None),
            kmips_index=(_sah.alsh_from_numpy(tree, "kmips/", dev)
                         if meta["has_kmips"] else None),
            deleted=t("deleted"), delta_items=t("delta_items"),
            delta_mask=t("delta_mask"), delta_used=meta["delta_used"],
            kmips_proj=(None if kmips_proj is None
                        else as_rows(kmips_proj, "kmips_proj", dev)))
        if art.fingerprint != meta["fingerprint"]:
            raise ValueError(
                f"artifact fingerprint mismatch under {artifact_dir!r} "
                f"step {step}: manifest says {meta['fingerprint'][:16]}..., "
                f"restored content hashes to {art.fingerprint[:16]}...")
        return art

    def __repr__(self) -> str:
        side = "rkmips" if self.index is not None else "kmips-only"
        fp = (f"{self._fingerprint[:12]}" if self._fingerprint is not None
              else "<uncomputed>")
        return (f"IndexArtifact({side}, n_base={self.n_base}, "
                f"n_users={self.n_users}, pending="
                f"{'yes' if self.has_pending else 'no'}, "
                f"fingerprint={fp}, device={self.device})")


def reconcile_compaction(snapshot: IndexArtifact, current: IndexArtifact,
                         compacted: IndexArtifact) -> IndexArtifact:
    """Re-stage the churn between ``snapshot`` and ``current`` onto
    ``compacted = snapshot.compact()`` (``artifact.py:687-746``): map
    snapshot-space ids into compacted space (the snapshot's ascending
    ``effective_ids`` are the compacted row order), re-apply later
    deletions and re-insert later staged rows in slot order. ``current``
    must be a delta-descendant of ``snapshot`` and ``compacted`` a
    delta-free compaction of it; anything else raises ``ValueError``."""
    if current is snapshot:
        return compacted
    if current.items is not snapshot.items and \
            current.base_fingerprint != snapshot.base_fingerprint:
        raise ValueError("reconcile_compaction: current is not a "
                         "delta-descendant of snapshot (different base "
                         "build)")
    if compacted.has_pending or compacted.n_base != snapshot.n_items:
        raise ValueError(
            f"reconcile_compaction: compacted ({compacted.n_base} base "
            f"rows, pending={compacted.has_pending}) is not a delta-free "
            f"compaction of snapshot ({snapshot.n_items} effective rows)")
    snap_del, cur_del = _host(snapshot.deleted), _host(current.deleted)
    snap_live, cur_live = _host(snapshot.delta_mask), _host(
        current.delta_mask)
    if current.delta_used < snapshot.delta_used \
            or (snap_del & ~cur_del).any() \
            or (~snap_live & cur_live)[:snapshot.delta_used].any():
        raise ValueError("reconcile_compaction: current is not a "
                         "delta-descendant of snapshot (deletions/staged "
                         "slots are not monotone)")
    out = compacted
    new_base_dead = np.where(cur_del & ~snap_del)[0]
    new_slot_dead = np.where(snap_live & ~cur_live)[0] + snapshot.n_base
    dead = np.concatenate([new_base_dead, new_slot_dead])
    if dead.size:
        ids_v = snapshot.effective_ids()  # ascending by construction
        pos = np.searchsorted(ids_v, dead)
        if (pos >= ids_v.size).any() or (ids_v[pos.clip(max=ids_v.size - 1)]
                                         != dead).any():
            raise ValueError("reconcile_compaction: post-snapshot deletion "
                             "targets a row the snapshot never served")
        out = out.delete_items(pos)
    fresh = np.where(cur_live[snapshot.delta_used:current.delta_used])[0] \
        + snapshot.delta_used
    if fresh.size:
        out = out.insert_items(current.delta_items[
            torch.as_tensor(fresh, device=current.device)])
    return out


def load_artifact(artifact_dir: str, *, step: int | None = None,
                  device=None, kmips_proj=None) -> IndexArtifact:
    """Module-level alias of ``IndexArtifact.load``."""
    return IndexArtifact.load(artifact_dir, step=step, device=device,
                              kmips_proj=kmips_proj)

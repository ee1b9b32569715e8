"""The dispatch stream: one ordered sequence of serving operations per
device mesh, sent by a controller rank and replayed by its followers
(PORT.md, "Serving under a mesh"; DESIGN.md SS12 restated for SPMD).

The reference drives every device from one process, so its threaded
runtime may form batches by timing. The port runs one process per rank,
and the ranks must issue the same collectives in the same order
(``dist.collectives.check_same_call``). Linger, deadlines and thread
interleaving differ from rank to rank, so one rank decides: the
controller, the mesh's flat position 0, admits the tickets and forms the
batches as a single-device runtime does, and broadcasts each operation
before it runs it; a replay thread on every follower receives the
operations in order and runs each on the follower's copy of the runtime.

An operation is a fixed-size int64 header (``FIELDS``), then its payload:
float32 rows (a dispatch's real queries, staged rows), int64 ids (the
rows to delete) and a JSON object (a warmup's ks and keywords, a swapped
version's fingerprint). Operations (``OPS``):

  * ``dispatch``: one micro-batch (k, n_cand, scan, ``pad_to``, its rows);
  * ``insert``, ``delete``, ``swap``: a new live version;
  * ``compact_start``: compact the live version off-thread, on the
    runtime's own compaction group; ``compact_land``: reconcile the churn
    that raced it and make it live (a follower first joins its own
    compaction);
  * ``warmup``, ``drain``, ``close``: the runtime's lifecycle;
  * ``beat``: nothing; the controller sends it when the stream has been
    idle for ``beat_seconds``, so an idle follower's receive never runs
    into the group's timeout.

One lock spans "broadcast the operation, then run its own collectives",
so two runtimes on one mesh (a gateway's tenants, dispatched by two pool
threads) never interleave theirs. A check that can raise before an
operation's collectives reads only the header and state every rank holds
alike (k against the corpus, a group against ``pad_to``, a staged row
against the buffer), so the ranks raise together: the controller's error
goes to its tickets' futures, a follower counts the failure, and no rank
is left waiting in a collective.

The stream runs on the policy's group (the default group): while a mesh
runtime is open, the ranks make no other mesh calls on that group
outside it.
"""

from __future__ import annotations

import json
import threading
import time
from typing import NamedTuple

import torch

from repro_torch.dist import collectives as _coll
from repro_torch.dist.policy import ShardingPolicy, rank_device

OPS = ("dispatch", "insert", "delete", "swap", "compact_start",
       "compact_land", "warmup", "drain", "close", "beat")
(DISPATCH, INSERT, DELETE, SWAP, COMPACT_START, COMPACT_LAND, WARMUP, DRAIN,
 CLOSE, BEAT) = range(len(OPS))
FIELDS = ("op", "runtime", "k", "n_cand", "scan", "pad_to", "rows",
          "n_float", "n_int", "n_obj", "aux")
SCANS = ("sketch", "exact")    # header code of a dispatch's scan; -1: None
BEAT_SECONDS = 5.0             # idle time after which the controller beats


class Op(NamedTuple):
    """One received operation: the header's fields (None where a dispatch
    left ``n_cand``/``scan`` to the config) and its payload."""

    code: int
    runtime: int
    k: int
    n_cand: int | None
    scan: str | None
    pad_to: int
    rows: int
    aux: int
    floats: torch.Tensor | None
    ints: torch.Tensor | None
    obj: object


def _dist():
    import torch.distributed as dist
    return dist


class DispatchStream:
    """The ordered operation stream of one mesh (module docstring). Made
    by ``stream_for`` at a rank's first mesh runtime; every runtime on the
    mesh registers, in construction order, and that order is its id on
    every rank."""

    def __init__(self, policy: ShardingPolicy):
        dist = _dist()
        self.policy = policy
        self.group = policy.group
        self.controller_rank = int(policy.mesh.mesh.flatten()[0])
        self.rank = dist.get_rank()
        self.is_controller = self.rank == self.controller_rank
        self.device = rank_device(policy)
        timeout = _coll.group_timeout(self.group)
        self.beat_seconds = BEAT_SECONDS if timeout is None else min(
            BEAT_SECONDS, timeout.total_seconds() / 4)
        self._lock = threading.Lock()          # an op and its collectives
        self._cond = threading.Condition()     # the registry
        self._runtimes: dict[int, object] = {}
        self._next_id = 0
        self._thread: threading.Thread | None = None
        self._last = time.monotonic()
        self.broken: BaseException | None = None
        self.sent = dict.fromkeys(OPS, 0)      # ops sent or replayed
        self.broadcasts = dict.fromkeys(OPS, 0)  # ... and their broadcasts

    # -- the registry --------------------------------------------------------

    def register(self, runtime) -> int:
        """Add a runtime and return its id; start the replay thread
        (followers) or the beat thread (controller) if none runs."""
        with self._cond:
            rid = self._next_id
            self._next_id += 1
            self._runtimes[rid] = runtime
            if self._thread is None:
                target = (self._beat_loop if self.is_controller
                          else self._replay_loop)
                self._thread = threading.Thread(
                    target=target, daemon=True,
                    name="stream-beat" if self.is_controller
                    else "stream-replay")
                self._thread.start()
            self._cond.notify_all()
        return rid

    def _drop(self, rid: int) -> None:
        with self._cond:
            self._runtimes.pop(rid, None)
            self._cond.notify_all()

    @property
    def active(self) -> bool:
        """Whether the stream's replay or beat thread is running."""
        t = self._thread
        return t is not None and t.is_alive()

    # -- the wire ------------------------------------------------------------

    def _bcast(self, t: torch.Tensor) -> None:
        _dist().broadcast(t, self.controller_rank, group=self.group)

    def _send(self, code: int, rid: int, *, k: int = 0, n_cand=None,
              scan=None, pad_to: int = 0, floats=None, ints=None, obj=None,
              aux: int = 0) -> None:
        rows = 0 if floats is None else int(floats.shape[0])
        dev = self.device
        if floats is not None:
            floats = floats.to(device=dev, dtype=torch.float32).reshape(-1)
        if ints is not None:
            ints = torch.as_tensor(ints, dtype=torch.int64).to(dev)
        blob = None
        if obj is not None:
            blob = torch.tensor(list(json.dumps(obj).encode()),
                                dtype=torch.uint8, device=dev)
        head = torch.tensor(
            [code, rid, k, -1 if n_cand is None else n_cand,
             -1 if scan is None else SCANS.index(scan), pad_to, rows,
             0 if floats is None else floats.numel(),
             0 if ints is None else ints.numel(),
             0 if blob is None else blob.numel(), aux],
            dtype=torch.int64, device=dev)
        self._bcast(head)
        parts = [p.contiguous() for p in (floats, ints, blob)
                 if p is not None and p.numel()]
        for part in parts:
            self._bcast(part)
        self.sent[OPS[code]] += 1
        self.broadcasts[OPS[code]] += 1 + len(parts)
        self._last = time.monotonic()

    def _receive(self) -> Op:
        dev = self.device
        head = torch.empty(len(FIELDS), dtype=torch.int64, device=dev)
        self._bcast(head)
        h = dict(zip(FIELDS, head.tolist()))
        parts = []
        for n, dtype in ((h["n_float"], torch.float32),
                         (h["n_int"], torch.int64),
                         (h["n_obj"], torch.uint8)):
            part = None
            if n:
                part = torch.empty(n, dtype=dtype, device=dev)
                self._bcast(part)
            parts.append(part)
        floats, ints, blob = parts
        obj = None if blob is None else json.loads(
            bytes(blob.cpu().tolist()).decode())
        self.sent[OPS[h["op"]]] += 1
        self.broadcasts[OPS[h["op"]]] += 1 + sum(p is not None for p in parts)
        return Op(h["op"], h["runtime"], h["k"],
                  None if h["n_cand"] < 0 else h["n_cand"],
                  None if h["scan"] < 0 else SCANS[h["scan"]], h["pad_to"],
                  h["rows"], h["aux"], floats, ints, obj)

    # -- the controller ------------------------------------------------------

    def run(self, code: int, rid: int, fn=None, **fields):
        """Controller: broadcast one operation of runtime ``rid``, then
        run ``fn()`` (the operation itself, with its collectives) under
        the stream's lock; returns what ``fn`` returns."""
        if not self.is_controller:
            raise RuntimeError(f"rank {self.rank} is a follower of the "
                               f"dispatch stream; the controller is rank "
                               f"{self.controller_rank}")
        with self._lock:
            if self.broken is not None:
                raise RuntimeError("the dispatch stream is broken") \
                    from self.broken
            try:
                self._send(code, rid, **fields)
            except BaseException as e:
                self.broken = e
                raise
            out = None if fn is None else fn()
            if code == CLOSE:
                self._drop(rid)
            return out

    def _beat_loop(self) -> None:
        while True:
            with self._cond:
                if not self._runtimes:
                    self._thread = None
                    return
                self._cond.wait(self.beat_seconds / 2)
            with self._lock:
                with self._cond:
                    live = bool(self._runtimes)
                if (not live or self.broken is not None or time.monotonic()
                        - self._last < self.beat_seconds):
                    continue
                try:
                    self._send(BEAT, -1)
                except BaseException as e:  # noqa: BLE001 -- ends the beat
                    self.broken = e

    # -- the followers -------------------------------------------------------

    def _replay_loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            try:
                op = self._receive()
            except BaseException as e:  # noqa: BLE001 -- wakes the waiters
                self._fail(e)
                return
            if op.code == BEAT:
                continue
            with self._cond:
                while op.runtime not in self._runtimes:
                    self._cond.wait()
                rt = self._runtimes[op.runtime]
            try:
                rt._follow(op)
            except BaseException as e:  # noqa: BLE001 -- wakes the waiters
                self._fail(e)
                return
            if op.code == CLOSE:
                with self._cond:
                    self._runtimes.pop(op.runtime, None)
                    if not self._runtimes:
                        self._thread = None
                        return

    def _fail(self, error: BaseException) -> None:
        with self._cond:
            self.broken = error
            runtimes = list(self._runtimes.values())
            self._thread = None
        for rt in runtimes:
            rt._stream_broke()

    def stats(self) -> dict:
        """Operations sent (controller) or replayed (follower), and the
        broadcasts they took, by operation name."""
        return {"ops": dict(self.sent), "broadcasts": dict(self.broadcasts)}


_STREAMS: dict[int, DispatchStream] = {}
_STREAMS_LOCK = threading.Lock()


def stream_for(policy: ShardingPolicy) -> DispatchStream:
    """The one dispatch stream of ``policy``'s mesh, made at first use
    (every rank reaches it at the same call: its first runtime on the
    mesh). Every runtime and gateway on the mesh shares it."""
    with _STREAMS_LOCK:
        stream = _STREAMS.get(id(policy.mesh))
        if stream is None or stream.policy.mesh is not policy.mesh:
            stream = DispatchStream(policy)
            _STREAMS[id(policy.mesh)] = stream
        return stream

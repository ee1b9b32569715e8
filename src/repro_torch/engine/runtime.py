"""Threaded serving runtime: a ticket pipeline with background compaction
(port of ``src/repro/engine/runtime.py``; DESIGN.md §12 is the contract,
PORT.md "Serving" the port's restatement).

A ``ServingRuntime`` wraps a ``RetrievalServer`` or a ``ReverseServer``:

  callers --submit--> admission deque --workers--> dispatch --> completion
                                            |   (dispatch lock)    thread
  maintenance thread --compact off-thread--swap               futures set

  * admission: ``submit`` validates the query up front
    (``serving.validate_query_rows``), enqueues one ``ServeTicket`` (a
    future) per row and returns at once;
  * workers pop the longest run of queue-head tickets that share one
    (k, n_cand, scan) signature, up to ``serve_batch_size``, pad it to the
    nearest rung of the config's bucket ladder (``server.bucket_for``) and
    dispatch it through the server's own ``_flush_batch``, the path the
    synchronous ``flush`` takes: runtime answers are bitwise the library
    answers. A partial run lingers once for more tickets unless its size
    is already a rung. ``warmup=True`` runs every rung's dispatch cells
    before the first ticket, so ``traces_after_warmup`` stays 0;
  * a worker records a CUDA event after each dispatch; the completion
    thread waits on it and then resolves the batch's futures, so a slow
    consumer never stalls dispatch and a ticket's latency ends when its
    answer is on the device;
  * the maintenance thread (``compaction=True``) watches the live
    artifact's delta buffer: past ``compact_fill`` (or on
    ``request_compaction()``) it snapshots the live version, compacts it
    off-thread, re-stages the churn that raced the build
    (``artifact.reconcile_compaction``) and swaps the result in under the
    dispatch lock, between flushes; with ``artifact_dir`` set it then
    saves it (``save(step, keep=)``).

Locks, always taken in the order mutate -> dispatch (workers take only
the dispatch lock): ``_admit`` (a condition) guards the deque and the
counters; ``_dispatch_lock`` serializes dispatch with ``swap``;
``_mutate_lock`` serializes version edits. Every thread issues its device
work to the device's default stream, in the order these locks give.

A ticket's deadline is checked when its batch is formed: an expired
ticket fails with ``TicketExpired`` before dispatch (a dispatch in flight
is never interrupted). ``drain()`` waits until every admitted ticket has
resolved; ``close()`` drains (optionally), stops the threads and fails
whatever is left.

Under a mesh (a server over a mesh policy; one process per rank) every
rank constructs the same runtime with the same arguments, and the mesh's
dispatch stream (``engine/controller.py``) orders its work. On the
controller rank the runtime works as above, and each dispatch, mutation,
swap, compaction start and landing, warmup, drain and close is broadcast
before it runs. A follower starts no workers and no maintenance thread:
the stream's replay thread runs each operation on the follower's copy,
``submit`` raises, and ``insert_items``, ``delete_items``, ``swap``,
``warmup``, ``drain`` and ``close`` wait for the controller's same call
in the stream and return its outcome on this rank. The compaction runs
off-thread on every rank at once, on a process group of the runtime's own
(``compact_policy.group``), while the dispatches go on; a follower lands
it only after its own compaction has joined.
"""

from __future__ import annotations

import collections
import dataclasses
import queue as _queue
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.dist import collectives as _coll
from repro_torch.engine import artifact as _artifact
from repro_torch.engine import controller as _ctl
from repro_torch.engine import serving as _serving

_UNSET = object()
_SHUTDOWN = object()


class TicketExpired(TimeoutError):
    """The ticket's deadline passed before its batch was dispatched."""


class ServeTicket:
    """One admitted query's future. ``result(timeout=)`` blocks for the
    server's answer (``ServeResult``/``ReverseResult``) or raises what
    dispatch raised; ``done()`` polls; ``seq`` is the admission number."""

    __slots__ = ("query", "k", "n_cand", "scan", "seq", "deadline",
                 "submitted_at", "done_at", "_event", "_value", "_error")

    def __init__(self, query, k: int, n_cand, scan, seq: int,
                 deadline: float | None):
        self.query = query
        self.k = k
        self.n_cand = n_cand
        self.scan = scan
        self.seq = seq
        self.deadline = deadline          # absolute monotonic time or None
        self.submitted_at = time.perf_counter()
        self.done_at: float | None = None
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._event.is_set()

    def _wait(self, timeout: float | None) -> None:
        if not self._event.wait(timeout):
            raise TimeoutError(f"ticket {self.seq} not resolved within "
                               f"{timeout}s")

    def result(self, timeout: float | None = None):
        """The answer, blocking up to ``timeout`` seconds for it."""
        self._wait(timeout)
        if self._error is not None:
            raise self._error
        return self._value

    def exception(self, timeout: float | None = None):
        """The dispatch error (None on success), blocking like result()."""
        self._wait(timeout)
        return self._error

    @property
    def latency(self) -> float | None:
        """Submit-to-resolve wall seconds; None while unresolved."""
        return None if self.done_at is None else \
            self.done_at - self.submitted_at

    def _resolve(self, value=None, error: BaseException | None = None):
        self._value = value
        self._error = error
        self.done_at = time.perf_counter()
        self._event.set()

    def __repr__(self) -> str:
        state = ("done" if self._error is None else
                 type(self._error).__name__) if self.done() else "pending"
        return f"ServeTicket(seq={self.seq}, k={self.k}, {state})"


class RuntimeStats(NamedTuple):
    """A snapshot of a runtime's counters (``ServingRuntime.stats``),
    monotone: every submitted ticket ends as one of completed, expired or
    failed. ``bucket_hits`` counts dispatches padded to a rung below the
    full batch, ``bucket_pad_rows`` the dead rows padding added;
    ``traces_after_warmup`` is the server's ``compile_count`` less its
    value at the warmup baseline; ``truncated`` counts tickets a scan
    budget answered conservatively."""

    submitted: int
    completed: int
    expired: int      # deadline missed before dispatch (TicketExpired)
    failed: int       # dispatch raised, or runtime closed undrained
    batches: int      # successful micro-batch dispatches
    swaps: int        # artifact versions made live
    compactions: int  # background compact -> reconcile -> swap cycles
    bucket_hits: int
    bucket_pad_rows: int
    traces_after_warmup: int
    truncated: int


def _ready_event(device: torch.device):
    """A CUDA event recorded on ``device``'s current stream, or None off
    the card."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


class WorkerPool:
    """Dispatch workers shared by many ``ServingRuntime``s (the gateway
    tier, DESIGN.md §15). A runtime made with ``pool=`` starts no workers
    of its own; the pool's threads go round the registered runtimes and
    form and dispatch their batches through each one's own
    ``_try_next_batch`` / ``_dispatch_and_complete``. A pool thread takes a
    runtime's dispatch lock without blocking and moves on when it is held,
    so one tenant's swap or compaction never stalls another's flushes; the
    runtime wakes the pool when it lets that lock go. An idle thread
    sleeps until a member wakes it, a member's linger deadline passes, or
    ``poll_interval`` seconds pass."""

    def __init__(self, workers: int = 1, *, poll_interval: float = 0.01):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self._cond = threading.Condition()
        self._members: list["ServingRuntime"] = []
        self._rr = 0
        self._kicked = False     # a wake-up since the last sweep began
        self._stop = threading.Event()
        self._poll = poll_interval
        self._threads = [
            threading.Thread(target=self._run, name=f"pool-worker-{i}",
                             daemon=True)
            for i in range(workers)]
        for t in self._threads:
            t.start()

    def register(self, runtime: "ServingRuntime") -> None:
        with self._cond:
            if self._stop.is_set():
                raise RuntimeError("worker pool is closed")
            if runtime not in self._members:
                self._members.append(runtime)
            self._cond.notify_all()

    def unregister(self, runtime: "ServingRuntime") -> None:
        with self._cond:
            if runtime in self._members:
                self._members.remove(runtime)

    def notify(self) -> None:
        """Wake the pool: a member admitted tickets or let its dispatch
        lock go."""
        with self._cond:
            self._kicked = True
            self._cond.notify_all()

    def _run(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                self._kicked = False
                members = list(self._members)
                start = self._rr
                self._rr = (self._rr + 1) % max(1, len(members))
            dispatched = False
            wake = None                   # the earliest linger deadline
            for i in range(len(members)):
                rt = members[(start + i) % len(members)]
                if not rt._dispatch_lock.acquire(blocking=False):
                    continue
                try:
                    batch = rt._try_next_batch()
                    if batch is not None:
                        dispatched = True
                        rt._dispatch_and_complete(batch)
                    elif rt._linger_until is not None:
                        wake = rt._linger_until if wake is None \
                            else min(wake, rt._linger_until)
                finally:
                    rt._dispatch_lock.release()
            if not dispatched:
                with self._cond:
                    if self._kicked or self._stop.is_set():
                        continue
                    timeout = self._poll if wake is None else \
                        min(self._poll, max(0.0, wake - time.monotonic()))
                    self._cond.wait(timeout)

    def close(self) -> None:
        """Stop the pool threads (close or re-home its runtimes first)."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=30)

    def __enter__(self) -> "WorkerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ServingRuntime:
    """The threaded serving loop over a ``RetrievalServer`` or a
    ``ReverseServer`` (module docstring).

    k             default k for ``submit`` (its ``k=`` overrides).
    workers       dispatch threads (dispatch itself is serialized by the
                  dispatch lock; more workers overlap batch formation).
    deadline      default per-ticket budget in seconds (None: none).
    batch_linger  seconds a worker waits once for a partial batch to fill
                  (skipped when the run's size is already a rung).
    warmup        run ``server.warmup(warmup_ks)`` before the workers
                  start and baseline ``traces_after_warmup`` at 0.
    warmup_ks     the ks to warm (default: ``k``).
    compaction    start the maintenance thread (artifact-backed servers).
    compact_fill  delta-buffer fill fraction that starts a compaction.
    keep          keep the newest ``keep`` saved versions (the just-saved
                  one always).
    compact_policy the ``ShardingPolicy`` compaction builds under
                  (default: the server's, or its engine's); under a mesh
                  the runtime gives it a process group of its own.
    artifact_dir  save each compacted version here (``save(step=n)``;
                  under a mesh the controller saves).
    poll_interval idle wakeup period of the threads (seconds).
    pool          a shared ``WorkerPool`` to dispatch through instead of
                  workers of this runtime's own (``workers`` is ignored).
    """

    def __init__(self, server, *, k: int | None = None, workers: int = 1,
                 deadline: float | None = None, batch_linger: float = 0.002,
                 warmup: bool = False, warmup_ks=None,
                 compaction: bool = False, compact_fill: float = 0.5,
                 compact_policy=None, artifact_dir: str | None = None,
                 keep: int | None = None, poll_interval: float = 0.05,
                 pool: WorkerPool | None = None):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if not 0.0 < compact_fill <= 1.0:
            raise ValueError(f"compact_fill must be in (0, 1], got "
                             f"{compact_fill}")
        self.server = server
        self._engine = getattr(server, "engine", None)
        self._is_reverse = self._engine is not None
        self.artifact = (self._engine.artifact if self._is_reverse
                         else server.artifact)
        if compaction and self.artifact is None:
            raise ValueError(
                "compaction=True needs an artifact-backed server: build "
                "the server from_artifact / engine.from_artifact so the "
                "runtime has a version to watch and swap")
        if keep is not None and artifact_dir is None:
            raise ValueError("keep= (artifact GC) needs artifact_dir=")
        self._default_k = k
        self._default_deadline = deadline
        self._linger = batch_linger
        self._poll = poll_interval
        self._compact_fill = compact_fill
        self._artifact_dir = artifact_dir
        self._keep = keep
        self._save_step = 0

        self._admit = threading.Condition()
        self._ticket_deque: collections.deque[ServeTicket] = \
            collections.deque()
        self._dispatch_lock = threading.Lock()
        self._mutate_lock = threading.Lock()
        self._completion: _queue.SimpleQueue = _queue.SimpleQueue()
        self._stop = threading.Event()
        self._closed = False
        self._seq = 0
        self._unfinished = 0
        self._counts = dict.fromkeys(
            ("submitted", "completed", "expired", "failed", "batches",
             "swaps", "compactions", "bucket_hits", "bucket_pad_rows",
             "truncated"), 0)
        self._pool = pool
        self._linger_until: float | None = None   # pooled-linger deadline
        self.last_compaction_seconds: float | None = None
        self._trace_base = server.compile_count
        if warmup:
            warm_ks = tuple(warmup_ks if warmup_ks is not None
                            else [] if k is None else [k])
            if not warm_ks:
                raise ValueError("warmup=True needs warmup_ks= (or a "
                                 "default k= to warm for)")

        # the mesh: the dispatch stream, and compaction on its own group
        policy = self._engine.policy if self._is_reverse else server.policy
        compact_policy = policy if compact_policy is None else compact_policy
        self._stream: _ctl.DispatchStream | None = None
        self._compact_group = None
        if policy.mesh is not None:
            if compact_policy.mesh is not None \
                    and compact_policy.mesh is not policy.mesh:
                raise ValueError("compact_policy must be single-device or "
                                 "on the server's own mesh")
            self._stream = _ctl.stream_for(policy)
            if compaction and compact_policy.mesh is not None:
                self._compact_group = _coll.spare_group()
                compact_policy = dataclasses.replace(
                    compact_policy, group=self._compact_group)
        elif compact_policy.mesh is not None:
            raise ValueError(
                "compact_policy over a mesh needs a runtime over that mesh "
                "(a server on its policy): otherwise the ranks' own timing "
                "would start their compactions")
        self._compact_policy = compact_policy
        self._follower = self._stream is not None \
            and not self._stream.is_controller
        # a follower's calls wait for the controller's in the stream
        self._mail_cond = threading.Condition()
        self._mail: dict[int, tuple] = {}
        self._mail_posted = self._mail_taken = 0
        self._mail_skip: set[int] = set()
        self._swap_inbox: collections.deque = collections.deque()
        self._following = None        # a follower's compaction in flight
        self._fault: BaseException | None = None
        self._rid = None if self._stream is None \
            else self._stream.register(self)

        # warmup runs before any worker exists, so no ticket races it;
        # without it the baseline is construction time
        if warmup:
            try:
                self.warmup(warm_ks)
            except BaseException:
                if self._stream is not None:     # every rank raises here
                    self._leave_stream(None)
                raise

        self._threads = [] if pool is not None or self._follower else [
            threading.Thread(target=self._worker_loop,
                             name=f"serve-worker-{i}", daemon=True)
            for i in range(workers)]
        self._completer = threading.Thread(target=self._completion_loop,
                                           name="serve-completer",
                                           daemon=True)
        self._compact_wake = threading.Event()
        self._compact_forced = threading.Event()
        self._compactor = None
        if compaction and not self._follower:
            self._compactor = threading.Thread(
                target=self._maintenance_loop, name="serve-compactor",
                daemon=True)
        self._completer.start()
        for t in self._threads:
            t.start()
        if self._compactor is not None:
            self._compactor.start()
        if pool is not None and not self._follower:
            pool.register(self)

    # -- admission ---------------------------------------------------------

    def submit(self, q, *, k: int | None = None, n_cand: int | None = None,
               scan: str | None = None, deadline=_UNSET):
        """Admit a query (d,) -> its ``ServeTicket``; a block (nq, d) ->
        one ticket per row. Validation happens here, before the queue;
        ``n_cand``/``scan`` are forward-server knobs; raises
        ``RuntimeError`` once the runtime is closed, and on a follower
        rank of a mesh (the controller admits every ticket)."""
        if self._follower:
            raise RuntimeError(
                f"runtime.submit on rank {self._stream.rank}: under a mesh "
                f"the controller rank {self._stream.controller_rank} admits "
                f"every ticket and the followers replay its dispatches")
        q = _serving.validate_query_rows(q, self.server._dim,
                                         "runtime.submit",
                                         self.server.device)
        k = self._default_k if k is None else k
        if k is None:
            raise ValueError("no k for this ticket: pass submit(..., k=) "
                             "or construct ServingRuntime(..., k=)")
        if self._is_reverse and (n_cand is not None or scan is not None):
            raise ValueError("n_cand/scan are forward-serving knobs; the "
                             "reverse pipeline has no per-ticket override")
        budget = self._default_deadline if deadline is _UNSET else deadline
        expiry = None if budget is None else time.monotonic() + budget
        rows = [q] if q.dim() == 1 else list(q.unbind(0))
        with self._admit:
            if self._closed:
                raise RuntimeError("runtime is closed: no new tickets "
                                   "(create a new ServingRuntime)")
            tickets = []
            for row in rows:
                tickets.append(ServeTicket(row, k, n_cand, scan, self._seq,
                                           expiry))
                self._seq += 1
            self._ticket_deque.extend(tickets)
            self._counts["submitted"] += len(tickets)
            self._unfinished += len(tickets)
            self._admit.notify_all()
        self._wake_pool()
        return tickets[0] if q.dim() == 1 else tickets

    # -- workers and completion --------------------------------------------

    def _wake_pool(self) -> None:
        """A pooled runtime wakes its pool when it admits tickets or lets
        the dispatch lock go (its own workers wait on ``_admit`` and the
        lock instead)."""
        if self._pool is not None:
            self._pool.notify()

    def _form_batch(self) -> list[ServeTicket]:
        """Pop the longest run of queue-head tickets sharing one signature,
        up to ``batch_size``, failing expired ones on the way. Caller
        holds ``_admit``."""
        size = self.server.batch_size
        batch: list[ServeTicket] = []
        sig = None
        now = time.monotonic()
        while self._ticket_deque and len(batch) < size:
            head = self._ticket_deque[0]
            if head.deadline is not None and now >= head.deadline:
                self._ticket_deque.popleft()
                self._completion.put(([head], None, TicketExpired(
                    f"ticket {head.seq} missed its deadline "
                    f"before dispatch"), None, None))
                continue
            head_sig = (head.k, head.n_cand, head.scan)
            if sig is None:
                sig = head_sig
            elif head_sig != sig:
                break
            batch.append(self._ticket_deque.popleft())
        return batch

    def _should_linger(self, n: int) -> bool:
        return (self._linger > 0 and n < self.server.batch_size
                and n not in self.server._ladder()
                and not self._stop.is_set())

    def _next_batch(self) -> list[ServeTicket] | None:
        """Blocking batch formation for this runtime's own workers; None
        when stopping with an empty queue."""
        with self._admit:
            lingered = False
            while True:
                if not self._ticket_deque:
                    if self._stop.is_set():
                        return None
                    self._admit.wait(self._poll)
                    lingered = False
                    continue
                if not lingered and self._should_linger(
                        len(self._ticket_deque)):
                    lingered = True
                    self._admit.wait(self._linger)
                    continue
                batch = self._form_batch()
                if batch:
                    return batch
                lingered = False      # the head tickets all expired

    def _try_next_batch(self) -> list[ServeTicket] | None:
        """Non-blocking batch formation for pool threads (which hold the
        dispatch lock): None while the queue is empty or lingering, the
        linger being a deadline (``_linger_until``) the pool wakes at."""
        with self._admit:
            n = len(self._ticket_deque)
            if n == 0:
                self._linger_until = None
                return None
            if self._should_linger(n):
                now = time.monotonic()
                if self._linger_until is None:
                    self._linger_until = now + self._linger
                    return None
                if now < self._linger_until:
                    return None
            self._linger_until = None
            return self._form_batch() or None

    def _dispatch_and_complete(self, batch: list[ServeTicket]) -> None:
        """Dispatch one run through the server's own flush path, padded
        to the nearest rung, and hand it to the completion thread with an
        event to wait on; an error goes to the tickets' futures. Caller
        holds the dispatch lock."""
        first = batch[0]
        group = [t.query for t in batch]
        try:
            pad_to = self.server.bucket_for(len(group))
            kw = {} if self._is_reverse else dict(n_cand=first.n_cand,
                                                  scan=first.scan)

            def flush():
                return self.server._flush_batch(group, first.k,
                                                pad_to=pad_to, **kw)

            if self._stream is None:
                results = flush()
            else:
                results = self._stream.run(
                    _ctl.DISPATCH, self._rid, flush, k=first.k,
                    n_cand=first.n_cand, scan=first.scan, pad_to=pad_to,
                    floats=torch.stack(group))
            ready = _ready_event(self.server.device)
        except BaseException as e:  # noqa: BLE001 -- routed to futures
            self._completion.put((batch, None, e, None, None))
            return
        self._completion.put((batch, results, None, pad_to, ready))

    def _worker_loop(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            with self._dispatch_lock:
                self._dispatch_and_complete(batch)

    def _completion_loop(self) -> None:
        while True:
            item = self._completion.get()
            if item is _SHUTDOWN:
                return
            batch, results, error, pad_to, ready = item
            if ready is not None:
                ready.synchronize()
            for i, t in enumerate(batch):
                if error is None:
                    t._resolve(value=results[i])
                else:
                    t._resolve(error=error)
            self._tally(len(batch), results, error, pad_to)

    def _tally(self, n: int, results, error, pad_to) -> None:
        """Count a resolved run of ``n`` tickets (a dispatch, an expiry or
        a failure), or on a follower a replayed dispatch."""
        with self._admit:
            c = self._counts
            if self._follower:
                c["submitted"] += n
            else:
                self._unfinished -= n
            if error is None:
                c["completed"] += n
                c["batches"] += 1
                c["truncated"] += sum(
                    1 for r in results if getattr(r, "truncated", False))
                if pad_to < self.server.batch_size:
                    c["bucket_hits"] += 1
                c["bucket_pad_rows"] += pad_to - n
            elif isinstance(error, TicketExpired):
                c["expired"] += n
            else:
                c["failed"] += n
            self._admit.notify_all()

    # -- artifact lifecycle ------------------------------------------------

    def _require_artifact(self) -> _artifact.IndexArtifact:
        if self.artifact is None:
            raise RuntimeError("runtime has no artifact: build the server "
                               "from an IndexArtifact to stream mutations")
        return self.artifact

    def _publish(self, artifact) -> _artifact.IndexArtifact:
        """Make ``artifact`` live on the server (the caller holds the
        dispatch lock, so it lands between flushes)."""
        self.server.swap(artifact)
        self.artifact = artifact
        with self._admit:
            self._counts["swaps"] += 1
        return artifact

    def _mutate(self, code: int, change, **fields):
        """Make ``change()``'s version live between flushes; under a mesh
        the operation goes through the stream first, so every rank makes
        the same change at the same place among its dispatches. The caller
        holds ``_mutate_lock``."""
        with self._dispatch_lock:
            def apply():
                return self._publish(change())
            art = apply() if self._stream is None else self._stream.run(
                code, self._rid, apply, **fields)
        self._wake_pool()
        return art

    def swap(self, artifact) -> None:
        """Make an externally built version live, between flushes;
        pending tickets survive and are answered against it. Under a mesh
        every rank passes its copy of the same version."""
        if self._stream is None:
            with self._mutate_lock:
                self._mutate(_ctl.SWAP, lambda: artifact)
            return
        fp = artifact.fingerprint
        if self._follower:
            with self._mail_cond:
                self._swap_inbox.append(artifact)
                self._mail_cond.notify_all()
            self._await(_ctl.SWAP)
            return
        with self._mutate_lock:
            self._mutate(_ctl.SWAP, lambda: artifact, obj=fp)

    def insert_items(self, rows) -> _artifact.IndexArtifact:
        """Stage rows on the live version and swap the new version in
        (between flushes). Returns the new version."""
        if self._stream is not None:
            rows = _staged_rows(rows, self.server.device)
        if self._follower:
            return self._await(_ctl.INSERT)
        with self._mutate_lock:
            art = self._mutate(
                _ctl.INSERT,
                lambda: self._require_artifact().insert_items(rows),
                floats=rows if self._stream is not None else None)
        self._compact_wake.set()
        return art

    def delete_items(self, ids) -> _artifact.IndexArtifact:
        """Retire rows on the live version and swap the new version in
        (between flushes). Returns the new version."""
        if self._stream is not None:
            ids = np.atleast_1d(np.asarray(ids, np.int64))
        if self._follower:
            return self._await(_ctl.DELETE)
        with self._mutate_lock:
            art = self._mutate(
                _ctl.DELETE,
                lambda: self._require_artifact().delete_items(ids),
                ints=ids if self._stream is not None else None)
        self._compact_wake.set()
        return art

    def request_compaction(self) -> None:
        """Ask the maintenance thread for a compaction now, whatever the
        fill (no-op without ``compaction=True`` or pending changes, and on
        a follower: the controller starts every compaction)."""
        self._compact_forced.set()
        self._compact_wake.set()

    def _maintenance_loop(self) -> None:
        while not self._stop.is_set():
            self._compact_wake.wait(self._poll)
            self._compact_wake.clear()
            if self._stop.is_set():
                return
            snapshot = self.artifact
            if snapshot is None or not snapshot.has_pending:
                self._compact_forced.clear()
                continue
            fill = snapshot.delta_used / snapshot.delta_capacity
            if not (self._compact_forced.is_set()
                    or fill >= self._compact_fill):
                continue
            self._compact_forced.clear()
            t0 = time.perf_counter()
            with self._mutate_lock:
                snapshot = self.artifact
                if self._stream is not None:     # the followers' snapshot
                    self._stream.run(_ctl.COMPACT_START, self._rid)
            # unlocked: traffic keeps flushing and mutations keep staging
            # onto descendants of the snapshot while the rebuild runs
            compacted = snapshot.compact(policy=self._compact_policy)
            with self._mutate_lock:
                merged = _artifact.reconcile_compaction(
                    snapshot, self.artifact, compacted)
                self._mutate(_ctl.COMPACT_LAND, lambda: merged)
                with self._admit:
                    self._counts["compactions"] += 1
            self.last_compaction_seconds = time.perf_counter() - t0
            if self._artifact_dir is not None:
                step = self._save_step
                self._save_step += 1
                merged.save(self._artifact_dir, step=step, keep=self._keep)

    # -- a follower of the dispatch stream ---------------------------------

    def _post(self, code: int, value, error) -> None:
        """Hand the outcome of a replayed caller-visible operation to the
        follower's matching call (``_await``)."""
        with self._mail_cond:
            seq = self._mail_posted
            self._mail_posted += 1
            if seq in self._mail_skip:          # its call timed out
                self._mail_skip.discard(seq)
            else:
                self._mail[seq] = (code, value, error)
            self._mail_cond.notify_all()

    def _await(self, code: int, timeout: float | None = None,
               timed_out=_UNSET):
        """Follower: the outcome of the controller's next caller-visible
        operation on this runtime, which must be ``code``; on timeout,
        ``timed_out`` (or ``TimeoutError`` when unset)."""
        end = None if timeout is None else time.monotonic() + timeout
        with self._mail_cond:
            seq = self._mail_taken
            self._mail_taken += 1
            while seq not in self._mail:
                fault = self._fault or self._stream.broken
                if fault is not None:
                    raise RuntimeError(
                        f"rank {self._stream.rank}: the runtime fell out of "
                        f"its dispatch stream before its "
                        f"{_ctl.OPS[code]}") from fault
                left = None if end is None else end - time.monotonic()
                if left is not None and left <= 0:
                    self._mail_skip.add(seq)
                    if timed_out is _UNSET:
                        raise TimeoutError(f"{_ctl.OPS[code]} not replayed "
                                           f"within {timeout}s")
                    return timed_out
                self._mail_cond.wait(self._poll if left is None
                                     else min(left, self._poll))
            got, value, error = self._mail.pop(seq)
        if got != code:
            raise RuntimeError(
                f"rank {self._stream.rank}: this rank called "
                f"{_ctl.OPS[code]} where the controller's call was "
                f"{_ctl.OPS[got]}; every rank must make the same runtime "
                f"calls in the same order")
        if error is not None:
            raise error
        return value

    def _stream_broke(self) -> None:
        with self._mail_cond:
            self._mail_cond.notify_all()

    def _follow(self, op: _ctl.Op) -> None:
        """Follower: run one operation of the stream on this rank's copy
        (the stream's replay thread). A dispatch's error is counted as the
        controller's goes to its tickets; a caller-visible operation's
        goes to the matching call."""
        with self._dispatch_lock:
            if op.code == _ctl.DISPATCH:
                group = list(op.floats.view(op.rows, -1).unbind(0))
                kw = {} if self._is_reverse else dict(n_cand=op.n_cand,
                                                      scan=op.scan)
                try:
                    results, error = self.server._flush_batch(
                        group, op.k, pad_to=op.pad_to, **kw), None
                except Exception as e:  # noqa: BLE001 -- as the controller
                    results, error = None, e
                self._tally(len(group), results, error, op.pad_to)
            elif op.code == _ctl.COMPACT_START:
                self._follow_compaction()
            elif op.code == _ctl.COMPACT_LAND:
                try:
                    self._land_compaction()
                except BaseException as e:  # noqa: BLE001 -- out of step
                    self._fault = e
                    self._stream_broke()
            else:
                try:
                    value, error = self._follow_call(op), None
                except BaseException as e:  # noqa: BLE001 -- to the caller
                    value, error = None, e
                self._post(op.code, value, error)

    def _follow_call(self, op: _ctl.Op):
        code = op.code
        if code == _ctl.INSERT:
            return self._publish(self._require_artifact().insert_items(
                op.floats.view(op.rows, -1)))
        if code == _ctl.DELETE:
            ids = np.zeros(0, np.int64) if op.ints is None \
                else op.ints.cpu().numpy()
            return self._publish(self._require_artifact().delete_items(ids))
        if code == _ctl.SWAP:
            with self._mail_cond:
                while not self._swap_inbox:
                    self._mail_cond.wait(self._poll)
                artifact = self._swap_inbox.popleft()
            if artifact.fingerprint != op.obj:
                raise ValueError("swap: this rank's version differs from the "
                                 "controller's (fingerprints differ); every "
                                 "rank must swap in the same version")
            return self._publish(artifact)
        if code == _ctl.WARMUP:
            ks, kw = op.obj
            cells = self.server.warmup(tuple(ks), **kw)
            self._trace_base = self.server.compile_count
            return cells
        if code == _ctl.DRAIN:
            return bool(op.aux)
        return None                                       # close

    def _follow_compaction(self) -> None:
        """Compact the live version off-thread, as the controller does with
        the same version at the same place in the stream."""
        snapshot, box = self.artifact, {}

        def run():
            if self.server.device.type == "cuda":
                torch.cuda.set_device(self.server.device)
            try:
                box["compacted"] = snapshot.compact(
                    policy=self._compact_policy)
            except BaseException as e:  # noqa: BLE001 -- raised at landing
                box["error"] = e

        thread = threading.Thread(target=run, name="serve-follow-compactor",
                                  daemon=True)
        self._following = (snapshot, thread, box, time.perf_counter())
        thread.start()

    def _land_compaction(self) -> None:
        snapshot, thread, box, t0 = self._following
        self._following = None
        thread.join()
        if "error" in box:
            raise box["error"]
        self._publish(_artifact.reconcile_compaction(
            snapshot, self.artifact, box["compacted"]))
        with self._admit:
            self._counts["compactions"] += 1
        self.last_compaction_seconds = time.perf_counter() - t0

    # -- lifecycle ---------------------------------------------------------

    def warmup(self, ks=None, **server_kwargs) -> int:
        """Run the server's warmup under the dispatch lock and baseline
        ``traces_after_warmup`` at 0. ``ks`` defaults to the runtime's k;
        keyword args go to ``server.warmup``. Returns the cells run."""
        ks = ks if ks is not None else \
            ([] if self._default_k is None else [self._default_k])
        if not ks:
            raise ValueError("warmup needs ks= (or a default k= on the "
                             "runtime)")
        if self._follower:
            return self._await(_ctl.WARMUP)

        def run():
            cells = self.server.warmup(tuple(ks), **server_kwargs)
            self._trace_base = self.server.compile_count
            return cells

        with self._dispatch_lock:
            cells = run() if self._stream is None else self._stream.run(
                _ctl.WARMUP, self._rid, run,
                obj=[[int(k) for k in ks], server_kwargs])
        self._wake_pool()
        return cells

    def rebaseline_traces(self) -> None:
        """Zero ``traces_after_warmup`` at the server's current count (the
        gateway's warmup warms one member of a share group and then
        re-baselines every member)."""
        with self._dispatch_lock:
            self._trace_base = self.server.compile_count
        self._wake_pool()

    @property
    def stats(self) -> RuntimeStats:
        """A consistent snapshot of the counters."""
        traces = self.server.compile_count - self._trace_base
        with self._admit:
            return RuntimeStats(traces_after_warmup=traces, **self._counts)

    @property
    def pending(self) -> int:
        """Tickets admitted but not yet resolved (queued or in flight)."""
        with self._admit:
            return self._unfinished

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every admitted ticket has resolved; False on
        timeout. Under a mesh every rank calls it: a follower returns what
        the controller's drain returned, once its replay has caught up."""
        if self._follower:
            return self._await(_ctl.DRAIN, timeout, timed_out=False)
        ok = self._wait_resolved(timeout)
        if self._stream is not None:
            self._stream.run(_ctl.DRAIN, self._rid, aux=int(ok))
        return ok

    def _wait_resolved(self, timeout: float | None) -> bool:
        end = None if timeout is None else time.monotonic() + timeout
        with self._admit:
            while self._unfinished > 0:
                remaining = self._poll if end is None \
                    else end - time.monotonic()
                if remaining <= 0:
                    return False
                self._admit.wait(min(remaining, self._poll))
            return True

    def close(self, *, drain: bool = True,
              timeout: float | None = None) -> None:
        """Refuse new tickets, optionally drain, stop and join every
        thread, and fail whatever is left undispatched. Idempotent. Under
        a mesh every rank calls it; the controller's close ends this
        runtime's part of every follower's replay."""
        with self._admit:
            already = self._closed
            self._closed = True
        if not already and drain:
            self.drain(timeout)
        self._stop.set()
        self._compact_wake.set()
        with self._admit:
            self._admit.notify_all()
        for t in self._threads:
            t.join(timeout=30)
        if self._compactor is not None:
            self._compactor.join(timeout=60)
        if self._pool is not None:
            # pool threads form batches only under the dispatch lock: once
            # unregistered and past it, none can race the sweep below
            self._pool.unregister(self)
            with self._dispatch_lock:
                pass
        with self._admit:
            leftover = list(self._ticket_deque)
            self._ticket_deque.clear()
        if leftover:
            self._completion.put((leftover, None, RuntimeError(
                "runtime closed before these tickets were dispatched"),
                None, None))
        if not already and self._stream is not None:
            self._leave_stream(timeout)
        if self._completer.is_alive():
            self._completion.put(_SHUTDOWN)
            self._completer.join(timeout=30)

    def _leave_stream(self, timeout: float | None) -> None:
        """The close operation: sent by the controller after its last
        dispatch and landing, awaited by a follower; then the compaction
        group goes."""
        if self._follower:
            self._await(_ctl.CLOSE, timeout, timed_out=None)
            if self._following is not None:
                self._following[1].join(timeout)
        else:
            self._stream.run(_ctl.CLOSE, self._rid)
        if self._compact_group is not None:
            import torch.distributed as dist
            dist.destroy_process_group(self._compact_group)
            self._compact_group = None

    def __enter__(self) -> "ServingRuntime":
        return self

    def __exit__(self, *exc) -> None:
        self.close(drain=exc == (None, None, None))


def _staged_rows(rows, device: torch.device) -> torch.Tensor:
    """Rows to stage as the float32 (r, d) block the stream carries; the
    artifact checks the rest (its dimensionality, the free slots) on every
    rank alike."""
    t = torch.as_tensor(rows)
    if t.dim() == 1:
        t = t[None]
    if t.dim() != 2 or not t.is_floating_point():
        raise ValueError(f"rows must be a floating (r, d) block, got "
                         f"{str(t.dtype).removeprefix('torch.')} of shape "
                         f"{tuple(t.shape)}")
    return t.to(device=device, dtype=torch.float32)

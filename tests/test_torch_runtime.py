"""The port's threaded serving runtime (``repro_torch.engine.runtime``) on
the CPU, at the reference tests' sizes (``tests/test_runtime.py``).

The same ticket stream through the runtime and through the synchronous
``flush`` resolves bitwise alike (forward and reverse, mixed signatures,
staged changes live); a warmed runtime adds no dispatch signature at any
rung; a ``swap`` lands between flushes and pending tickets survive it;
background compaction never blocks a flush or a mutation, and the churn
that raced it is re-staged onto the compacted base and saved; deadlines
expire tickets before dispatch; dispatch errors go to the futures; close
drains and then refuses.

Every wait passes a timeout, and every gate a test puts into the dispatch
path is released in ``finally``, so a failure never wedges a thread.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.engine import (IndexArtifact, RetrievalServer,
                                RkMIPSEngine, ServingRuntime, TicketExpired,
                                WorkerPool, get_config, load_artifact)
from test_torch_serving import CFG, K, staged_rows, workload

WAIT = 60


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return workload()


@pytest.fixture(scope="module")
def artifact(data):
    items, users, _ = data
    return IndexArtifact.build(items, users,
                               torch.Generator().manual_seed(31),
                               config=get_config("sah").replace(**CFG),
                               device="cpu")


def assert_same(got, want):
    if hasattr(want, "ids"):
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(got.values, want.values)
    else:
        assert torch.equal(got.predictions, want.predictions)
        assert got.truncated == want.truncated
    assert got.k == want.k


def server(art, mode):
    if mode == "forward":
        return RetrievalServer.from_artifact(art)
    return RkMIPSEngine.from_artifact(art, device="cpu").reverse_server()


@pytest.mark.parametrize("mode", ["forward", "reverse"])
def test_runtime_matches_sync_flush_bitwise(data, artifact, mode):
    """Tickets from three threads through a warmed runtime equal the
    synchronous flush ticket for ticket, on a version with staged
    changes; no signature is added after warmup."""
    _, _, q = data
    art = artifact.delete_items([4]).insert_items(staged_rows(data[0]))
    sync = server(art, mode)
    sync.submit(q)
    want = sync.flush(K)
    with ServingRuntime(server(art, mode), k=K, workers=2,
                        warmup=True) as rt:
        got = [None] * len(q)

        def send(rows):
            for i in rows:
                got[i] = rt.submit(q[i])

        threads = [threading.Thread(target=send, args=(range(j, 12, 3),))
                   for j in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        for t, w in zip(got, want):
            assert_same(t.result(timeout=WAIT), w)
            assert t.done() and t.exception(0) is None and t.latency >= 0
        assert rt.drain(timeout=WAIT)
        st = rt.stats
        assert st.submitted == st.completed == 12
        assert st.expired == st.failed == 0 and st.batches >= 3
        assert st.traces_after_warmup == 0 and rt.pending == 0
        assert st.bucket_pad_rows >= 0 and st.bucket_hits <= st.batches


def test_mixed_signatures_fragment_but_never_cross(data, artifact):
    _, _, q = data
    sync = server(artifact, "forward")
    want = {}
    for k in (2, 5):
        sync.submit(q)
        want[k] = sync.flush(k)
    with ServingRuntime(server(artifact, "forward")) as rt:
        ks = [2 if i % 2 == 0 else 5 for i in range(12)]
        tickets = [rt.submit(q[i], k=k) for i, k in enumerate(ks)]
        for i, (k, t) in enumerate(zip(ks, tickets)):
            got = t.result(timeout=WAIT)
            assert got.k == k
            assert_same(got, want[k][i])
        assert rt.stats.batches >= 2
        exact = rt.submit(q[0], k=2, scan="exact").result(timeout=WAIT)
        assert exact.k == 2


def test_bucket_stats_and_a_cold_runtime(data, artifact):
    """One ticket at a time on a ladder (1, 2) under a batch of 4: every
    dispatch hits rung 1 with no padding; a cold runtime counts the
    signatures it adds, a warmed one none, and ``warmup`` re-baselines."""
    _, _, q = data
    with ServingRuntime(server(artifact, "forward"), k=K,
                        batch_linger=0.0) as rt:
        for i in range(3):
            rt.submit(q[i]).result(timeout=WAIT)
        st = rt.stats
        assert st.batches == 3 and st.bucket_hits == 3
        assert st.bucket_pad_rows == 0 and st.traces_after_warmup == 1
        assert rt.warmup() == 6 and rt.stats.traces_after_warmup == 0
        rt.submit(q[:3])
        assert rt.drain(timeout=WAIT)
        assert rt.stats.traces_after_warmup == 0
    with pytest.raises(ValueError, match=r"warmup=True needs warmup_ks="):
        ServingRuntime(server(artifact, "forward"), warmup=True)


def test_pooled_linger_ends_at_its_deadline(data, artifact):
    """On a shared pool, a lone ticket off the ladder lingers for
    ``batch_linger`` and is dispatched at its deadline, not at the pool's
    next idle poll."""
    _, _, q = data
    art = artifact.with_config(artifact.config.replace(serve_buckets=()))
    with WorkerPool(1, poll_interval=5.0) as pool:
        rt = ServingRuntime(RetrievalServer.from_artifact(art), k=K,
                            batch_linger=0.05, pool=pool)
        try:
            t = rt.submit(q[0])
            assert t.result(timeout=WAIT).k == K
            assert 0.05 <= t.latency < 2.0
            assert rt.stats.bucket_pad_rows == 3
        finally:
            rt.close(timeout=WAIT)


def test_ctor_guards_and_submit_validation(data, artifact):
    items, _, q = data
    with pytest.raises(ValueError, match=r"workers must be >= 1"):
        ServingRuntime(server(artifact, "forward"), k=K, workers=0)
    with pytest.raises(ValueError, match=r"compact_fill must be in"):
        ServingRuntime(server(artifact, "forward"), k=K, compact_fill=0.0)
    with pytest.raises(ValueError, match=r"needs artifact_dir="):
        ServingRuntime(server(artifact, "forward"), k=K, keep=2)
    bare = RetrievalServer(items, np.array([1, 2], np.uint32),
                           config=artifact.config,
                           proj=artifact.kmips_proj, device="cpu")
    with pytest.raises(ValueError, match=r"artifact-backed"):
        ServingRuntime(bare, k=K, compaction=True)
    with ServingRuntime(server(artifact, "forward")) as rt:
        with pytest.raises(ValueError, match=r"no k for this ticket"):
            rt.submit(q[0])
        with pytest.raises(ValueError, match=r"runtime.submit: query "
                                             r"dimensionality"):
            rt.submit(q[0][:-1], k=K)
        assert rt.pending == 0 and rt.stats.submitted == 0
    with ServingRuntime(server(artifact, "reverse"), k=K) as rrt:
        with pytest.raises(ValueError, match=r"forward-serving knobs"):
            rrt.submit(q[0], n_cand=8)


def test_swap_lands_between_flushes_and_tickets_survive(data, artifact):
    """A swap issued while a batch is in flight waits for it: the batch
    answers on the version it was dispatched on, later tickets on the new
    version, with no new signature for a delete-only change."""
    _, _, q = data
    sync = server(artifact, "forward")
    sync.submit(q[:8])
    old = sync.flush(K)
    dels = sorted({int(old[4].ids[0]), int(old[5].ids[0])})
    art2 = artifact.delete_items(dels)
    sync.swap(art2)
    sync.submit(q[4:8])
    new = sync.flush(K)
    assert any(not torch.equal(a.ids, b.ids) for a, b in zip(old[4:], new))

    srv = server(artifact, "forward")
    rt = ServingRuntime(srv, k=K, batch_linger=0.0)
    orig = srv._flush_batch
    inflight, gate = threading.Event(), threading.Event()
    armed = [True]

    def gated(group, k, **kw):
        if armed[0]:
            armed[0] = False
            inflight.set()
            assert gate.wait(WAIT)
        return orig(group, k, **kw)

    srv._flush_batch = gated
    swapper = threading.Thread(target=rt.swap, args=(art2,))
    try:
        first = rt.submit(q[:4])
        assert inflight.wait(10)
        swapper.start()
        time.sleep(0.1)
        assert swapper.is_alive() and not first[0].done()
        gate.set()
        swapper.join(WAIT)
        assert not swapper.is_alive()
        for t, w in zip(first, old):
            assert_same(t.result(timeout=WAIT), w)
        for t, w in zip(rt.submit(q[4:8]), new):
            assert_same(t.result(timeout=WAIT), w)
        assert rt.stats.swaps == 1 and srv.compile_count == 1
    finally:
        gate.set()
        srv._flush_batch = orig
        rt.close(timeout=WAIT)
        if swapper.ident is not None:
            swapper.join(5)


@pytest.mark.parametrize("mode", ["forward", "reverse"])
def test_compaction_races_mutations(data, artifact, monkeypatch, tmp_path,
                                    mode):
    """While the off-thread compaction is held open, tickets resolve and
    mutations stage; when it lands, the raced churn is re-staged onto the
    compacted base, the merged version is saved (``keep=``), and the
    runtime answers as a synchronous server on it."""
    items, _, q = data
    rows = staged_rows(items, seed=7)
    more = (rows * 0.9).astype(np.float32)
    started, release = threading.Event(), threading.Event()
    orig = IndexArtifact.compact

    def gated(self, **kw):
        started.set()
        assert release.wait(WAIT)
        return orig(self, **kw)

    monkeypatch.setattr(IndexArtifact, "compact", gated)
    adir = str(tmp_path / "versions")
    rt = ServingRuntime(server(artifact, mode), k=K, compaction=True,
                        compact_fill=1.0, poll_interval=0.01,
                        artifact_dir=adir, keep=2)
    try:
        snapshot = rt.insert_items(rows)
        rt.request_compaction()
        assert started.wait(20)
        rt.submit(q[0]).result(timeout=WAIT)      # serving keeps flowing
        rt.insert_items(more[:2])                 # ... and so do changes
        rt.delete_items([5])
        assert rt.stats.compactions == 0
        release.set()
        end = time.monotonic() + WAIT
        while rt.stats.compactions < 1:
            assert time.monotonic() < end, "compaction never landed"
            time.sleep(0.02)
        merged = rt.artifact
        assert merged.n_base == snapshot.n_items
        assert merged.delta_used == 2 and merged.has_pending
        assert merged.n_items == artifact.n_items + 3 + 2 - 1
        assert rt.stats.swaps == 4
        sync = server(merged, mode)
        sync.submit(q[:4])
        for t, w in zip(rt.submit(q[:4]), sync.flush(K)):
            assert_same(t.result(timeout=WAIT), w)
        step0 = os.path.join(adir, "step_00000000", "manifest.json")
        while not os.path.exists(step0):
            assert time.monotonic() < end, "the compacted save never landed"
            time.sleep(0.02)
        assert load_artifact(adir, device="cpu").fingerprint == \
            merged.fingerprint
    finally:
        release.set()
        rt.close(timeout=WAIT)


def test_deadlines_expire_before_dispatch(data, artifact):
    _, _, q = data
    with ServingRuntime(server(artifact, "forward"), k=K) as rt:
        dead = rt.submit(q[0], deadline=0.0)
        with pytest.raises(TicketExpired, match=r"missed its deadline"):
            dead.result(timeout=WAIT)
        assert isinstance(dead.exception(1), TicketExpired)
        assert rt.submit(q[1]).result(timeout=WAIT).k == K
        assert rt.drain(timeout=WAIT)
        st = rt.stats
        assert st.expired == 1 and st.completed == 1 and st.failed == 0


def test_dispatch_errors_go_to_the_futures(data, artifact):
    _, _, q = data
    with ServingRuntime(server(artifact, "forward")) as rt:
        bad = rt.submit(q[0], k=10_000)
        with pytest.raises(ValueError, match=r"outside \[1,"):
            bad.result(timeout=WAIT)
        assert rt.submit(q[1], k=K).result(timeout=WAIT).k == K
        st = rt.stats
        assert st.failed == 1 and st.completed == 1
    with ServingRuntime(server(artifact, "reverse")) as rt:
        with pytest.raises(ValueError, match=r"k_max=8"):
            rt.submit(q[0], k=9).result(timeout=WAIT)


def test_close_drains_then_refuses(data, artifact):
    _, _, q = data
    rt = ServingRuntime(server(artifact, "reverse"), k=K)
    tickets = rt.submit(q[:6])
    rt.close(timeout=WAIT)
    for t in tickets:
        assert t.done() and t.exception(0) is None
    with pytest.raises(RuntimeError, match=r"runtime is closed"):
        rt.submit(q[0])
    rt.close()
    assert rt.stats.completed == 6 and rt.pending == 0
    # a ticket still in flight times out its waiter, not the runtime
    slow = ServingRuntime(server(artifact, "forward"), k=K,
                          batch_linger=0.0)
    gate = threading.Event()
    orig = slow.server._flush_batch

    def gated(*args, **kw):
        assert gate.wait(WAIT)
        return orig(*args, **kw)

    slow.server._flush_batch = gated
    try:
        t = slow.submit(q[0])
        with pytest.raises(TimeoutError, match=r"not resolved within"):
            t.result(timeout=0.2)
    finally:
        gate.set()
        slow.close(timeout=WAIT)
    assert t.result(timeout=WAIT).k == K


def test_async_servers_from_the_engine(data, artifact):
    _, _, q = data
    eng = RkMIPSEngine.from_artifact(artifact, device="cpu")
    with eng.async_server(k=K) as fwd, eng.async_reverse_server(k=K) as rev:
        f, r = fwd.submit(q[0]), rev.submit(q[0])
        assert f.result(timeout=WAIT).ids.shape == (K,)
        assert r.result(timeout=WAIT).predictions.shape == (64,)

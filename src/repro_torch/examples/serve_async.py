"""Async serving: the threaded ticket pipeline with background compaction
(twin of ``examples/serve_async.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_async [--device cpu]

The walkthrough of DESIGN.md SS12, submit -> future -> compact-in-flight:

1. build an ``IndexArtifact`` and stand up a ``ServingRuntime`` over the
   forward retrieval server (``engine.async_server``): ``submit`` returns
   a future (``ServeTicket``) immediately, worker threads micro-batch the
   queue through the server's own flush path; answers are bitwise the
   synchronous ``flush`` on the same stream, and the dispatch signatures
   ("compiles") stay at one per batch shape;
2. stream mutations while traffic flows: ``insert_items`` /
   ``delete_items`` stage deltas and hot-swap the new version between
   flushes; pending tickets survive every swap;
3. the delta buffer fills past ``compact_fill``: the maintenance thread
   rebuilds the next base OFF-THREAD (tickets keep resolving while it
   runs), re-stages whatever churn raced the build
   (``reconcile_compaction``), swaps the merged version live, and
   persists it under the ``keep=`` GC policy (the walkthrough waits for
   that save before it loads the version back);
4. deadlines: a ticket that waits past its budget fails with
   ``TicketExpired`` before dispatch instead of wedging the queue;
5. ``close()`` drains: every future resolves, then ``submit`` refuses.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch import IndexArtifact, RkMIPSEngine, get_config
from repro_torch.data import synthetic
from repro_torch.engine import RetrievalServer, TicketExpired
from repro_torch.examples._common import add_flags, check
from repro_torch.train import checkpoint as ckpt

COMPACTION_WAIT = 120    # seconds the compaction may take to land


def run(items, users, queries, trending, *, k: int,
        generator: torch.Generator, device="cuda") -> dict:
    """The walkthrough over (items, users): ``queries`` through the
    runtime, ``trending`` staged while tickets are in flight, the
    compaction, a deadline, ``close()``. The build's draws come from
    ``generator`` (a CPU generator). Returns the printed figures."""
    cfg = get_config("sah").replace(delta_capacity=64, serve_batch_size=8)
    art = IndexArtifact.build(items, users, generator, config=cfg,
                              device=device)
    eng = RkMIPSEngine.from_artifact(art, device=device)
    print(f"built v1: {art.n_base} items, fingerprint "
          f"{art.fingerprint[:16]}...")
    out = {"fingerprint_v1": art.fingerprint}

    with tempfile.TemporaryDirectory() as versions:
        with eng.async_server(k=k, compaction=True, compact_fill=0.5,
                              poll_interval=0.01, artifact_dir=versions,
                              keep=3) as rt:
            # -- 1. tickets are futures; answers == synchronous flush -----
            tickets = rt.submit(queries)         # returns immediately
            answers = [t.result(timeout=60) for t in tickets]
            lat = sorted(t.latency for t in tickets)
            sync = RetrievalServer.from_artifact(art)
            sync.submit(queries)
            ref = sync.flush(k)
            check(all(torch.equal(a.ids, r.ids)
                      for a, r in zip(answers, ref)),
                  "async answers differ from the synchronous flush")
            out["p50_ms"] = lat[len(lat) // 2] * 1e3
            out["compiles"] = rt.server.compile_count
            print(f"{len(tickets)} tickets answered async, bitwise == "
                  f"sync flush (p50 latency {out['p50_ms']:.1f}"
                  f" ms, compiles={out['compiles']})")

            # -- 2. mutations hot-swap between flushes ---------------------
            inflight = rt.submit(queries[:16])   # tickets before the swaps
            rt.insert_items(trending)            # 40/64 slots: past the fill
            rt.delete_items([0, 7])
            for t in inflight:                   # ...survive them
                t.result(timeout=60)

            # -- 3. compaction lands in the background ---------------------
            deadline = time.monotonic() + COMPACTION_WAIT
            while rt.stats.compactions < 1:
                rt.submit(queries[0]).result(timeout=60)  # traffic flows
                check(time.monotonic() <= deadline,
                      "compaction never landed")
                time.sleep(0.02)
            merged = rt.artifact
            out["compaction_s"] = rt.last_compaction_seconds
            print(f"compacted off-thread in "
                  f"{rt.last_compaction_seconds:.2f}s: new base "
                  f"{merged.n_base} rows, churn re-staged = "
                  f"{merged.delta_used} (tickets kept resolving)")
            # the runtime counts a compaction when it lands and persists
            # the merged version after: wait for the save before loading
            while ckpt.latest_step(versions) is None:
                check(time.monotonic() <= deadline,
                      "the merged version was never persisted")
                time.sleep(0.02)
            back = IndexArtifact.load(versions, device=device)
            check(back.fingerprint == merged.fingerprint,
                  "the persisted version's fingerprint differs from the "
                  "merged one")
            print(f"merged version persisted + verified under keep=3 GC "
                  f"({back.fingerprint[:16]}...)")
            out.update(n_base_merged=merged.n_base,
                       restaged=merged.delta_used)

            # -- 4. deadlines fail fast, pre-dispatch ----------------------
            doomed = rt.submit(queries[1], deadline=0.0)
            try:
                doomed.result(timeout=30)
            except TicketExpired as e:
                out["expired"] = str(e)
                print(f"deadline honored: {e}")

            st = rt.stats
            out["stats"] = st
            print(f"stats: {st.completed} completed / {st.expired} expired "
                  f"over {st.batches} batches, {st.swaps} swaps, "
                  f"{st.compactions} compaction")
        # -- 5. the context manager drained and closed the runtime --------
        try:
            rt.submit(queries[0])
        except RuntimeError as e:
            out["closed"] = str(e)
            print(f"closed: {e}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-items", type=int, default=4096)
    ap.add_argument("--m-users", type=int, default=512)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=64)
    add_flags(ap)
    args = ap.parse_args(argv)

    gen = torch.Generator().manual_seed(args.seed)
    items, users = synthetic.recommendation_data(
        gen, args.n_items, args.m_users, args.dim, device=args.device)
    queries = synthetic.queries_from_items(gen, items, args.queries)
    pick = torch.randint(0, args.n_items, (2, 40), generator=gen)
    pick = pick.to(items.device)
    trending = 0.65 * (items[pick[0]] + items[pick[1]])
    return run(items, users, queries, trending, k=args.k, generator=gen,
               device=args.device)


if __name__ == "__main__":
    main()

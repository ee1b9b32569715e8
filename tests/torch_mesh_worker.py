"""The rank body of the gloo worlds that tests/test_torch_dist.py spawns.

JAX-free on purpose: ``torch.multiprocessing.spawn`` re-imports this module
in every rank, and a rank runs the port alone. Each world is spawned once
(``spawn_world``); every rank runs ``rank_checks`` under its mesh (the
engine) and ``serving_checks`` (the servers, the runtime under the
controller rank, a gateway) and writes what it saw to ``rank<r>.npz``,
which the tests hold against the single-device port and the reference.
The group's timeout is short and every wait takes one, so a stream that
falls out of step fails the test instead of hanging it.
"""

from __future__ import annotations

import datetime
import math
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

# world name -> mesh shape: 1-D over "data", or make_test_mesh's
# ("data", "model")
WORLDS = {"2": (2,), "2x2": (2, 2), "3": (3,)}
N, M, D = 640, 1000, 16
BUILD = dict(k_max=10, tile=64, n_bits=64, leaf_size=8, chunk=32)
K = 5
BUDGET = 1
SEED = 7
STATS = ("blocks_alive", "users_alive", "n_no_lb", "n_yes_norm", "n_scan",
         "tiles_scanned", "chunks", "truncated")
PLAN = ("blocks_alive", "users_alive", "n_no_lb", "n_yes_norm", "n_scan",
        "truncated")
# the serving checks' config: 4 reverse queries are one dispatch, the 6
# forward users two (4, then 2 at rung 2)
SERVE = dict(serve_batch_size=4, serve_buckets=(1, 2))
# what rank 0 alone writes: the controller's comparisons of its tickets
LEAD_ONLY = ("rt/reverse_same", "rt/forward_same", "rt/bad_k_error",
             "gated/held", "gated/after_same", "gw/same", "gw/swapped_same")
GROUP_TIMEOUT = 60       # seconds a collective may wait
WAIT = 30                # seconds any one wait of the serving checks may take


def mf_rows(rng, r, d, h, rank=8):
    w = np.abs(rng.standard_normal((r, rank)))
    x = w @ h / rank + np.abs(rng.standard_normal((r, d)))
    return (x * np.exp(0.1 * rng.standard_normal((r, 1)))).astype(np.float32)


def corpus():
    """MF-like items and users (with exact duplicates), reverse queries
    from the top items by norm, forward queries from the users, rows to
    stage and ids to delete (one of them in P')."""
    rng = np.random.default_rng(SEED)
    h = np.abs(rng.standard_normal((8, D)))
    items, users = mf_rows(rng, N, D, h), mf_rows(rng, M, D, h)
    items[5] = items[3]
    users[7] = users[2]
    order = np.argsort(-np.linalg.norm(items, axis=1), kind="stable")
    queries = items[np.concatenate([order[rng.choice(13, 3, replace=False)],
                                    order[rng.choice(128, 1)]])]
    fwd = users[rng.choice(M, 6, replace=False)]
    inserts = 1.05 * items[order[20:23]]
    deletes = np.array([order[0], order[40], order[300]])
    return items, users, queries, fwd, inserts, deletes


def index_arrays(index, prefix: str) -> dict:
    """A SAHIndex's leaves as numpy arrays named ``<prefix><field>``."""
    out = {}
    for f, v in index._asdict().items():
        if f == "alsh":
            out.update({f"{prefix}alsh/{g}": w.numpy()
                        for g, w in v._asdict().items()})
        else:
            out[prefix + f] = v.numpy()
    return out


def result_arrays(res, prefix: str) -> dict:
    out = {prefix + "pred": res.predictions.numpy()}
    out.update({prefix + f: getattr(res.stats, f).numpy() for f in STATS})
    out[prefix + "funnel"] = np.array(tuple(res.funnel))
    return out


def raises(exc, fn) -> str:
    """The message of ``exc`` raised by ``fn()`` ("" if nothing was)."""
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


def rank_checks(shape: tuple, art_dir: str) -> dict:
    """Everything one rank runs under its mesh: the mesh build from the
    corpus, then the engine on the reference's saved artifact (f32, int8,
    a scan budget, a delta version, the forward scan, signatures) and the
    refusals."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import ShardingPolicy, shard_rank
    from repro_torch.engine import IndexArtifact, RkMIPSEngine, get_config
    from repro_torch.launch import mesh as mesh_lib

    if len(shape) == 2:
        mesh = mesh_lib.make_test_mesh(*shape, device_type="cpu")
    else:
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data",))
    policy = ShardingPolicy(mesh=mesh)
    items, users, queries, fwd, inserts, deletes = corpus()
    out = {"shard_rank": np.array(shard_rank(policy)),
           "production_error": np.array(raises(
               RuntimeError, lambda: mesh_lib.make_production_mesh(
                   device_type="cpu")))}

    cfg = get_config("sah").replace(**BUILD)
    built = IndexArtifact.build(items, users,
                                torch.Generator().manual_seed(SEED),
                                config=cfg, device="cpu", policy=policy)
    out.update(index_arrays(built.index, "build/"))
    out["build/sharded"] = np.array(built.build_timings.sharded)

    art = IndexArtifact.load(art_dir, device="cpu")
    q = torch.from_numpy(queries)
    eng = RkMIPSEngine.from_artifact(art, policy=policy)
    out["m_local"] = np.array(eng._shard.n_users)
    out["n_blocks_local"] = np.array(eng._shard.n_blocks)
    out.update(result_arrays(eng.query_batch(q, K), "f32/"))
    for name, knob in (("int8", dict(scan_precision="int8")),
                       ("budget", dict(scan_budget=BUDGET))):
        e = RkMIPSEngine(art.config.replace(**knob), policy=policy)
        out.update(result_arrays(e.attach(art).query_batch(q, K),
                                 name + "/"))
    one = eng.query(q[0], K)
    out["query/pred"] = one.predictions.numpy()

    changed = art.delete_items(deletes).insert_items(inserts)
    for name, prec in (("delta", "f32"), ("delta8", "int8")):
        e = RkMIPSEngine(art.config.replace(scan_precision=prec),
                         policy=policy)
        out.update(result_arrays(e.attach(changed).query_batch(q, K),
                                 name + "/"))

    fw = eng.kmips(torch.from_numpy(fwd), K, n_cand=N)
    out.update({"fwd/vals": fw.values.numpy(), "fwd/ids": fw.ids.numpy(),
                "fwd/tiles": np.array(fw.tiles_visited)})

    # warmup: one cell, for the empty buffer and the artifact's buffer
    sig = RkMIPSEngine.from_artifact(art, policy=policy)
    counts = [sig.warmup([K], batch_sizes=(len(q),)),
              sig.rkmips_compile_count]
    sig.query_batch(q, K)
    sig.query_batch(q, K)
    counts.append(sig.rkmips_compile_count)
    sig.query_batch(q[:2], K)
    counts.append(sig.rkmips_compile_count)
    out["signatures"] = np.array(counts)

    mine = q if dist.get_rank() else 2 * q
    out["spmd_error"] = np.array(raises(
        ValueError, lambda: sig.query_batch(mine, K)))
    out["mapped_error"] = np.array(raises(
        RuntimeError, lambda: eng.query_batch_mapped(q, K)))
    out.update(serving_checks(policy, art))
    return out


def served_arrays(res, prefix: str) -> dict:
    """A reverse server's tickets as ``result_arrays`` of one batch."""
    from repro_torch.core.sah import QueryStats
    stats = QueryStats(*(torch.stack([getattr(r.stats, f) for r in res])
                         for f in QueryStats._fields))
    return result_arrays(SimpleNamespace(
        predictions=torch.stack([r.predictions for r in res]), stats=stats,
        funnel=res[0].funnel), prefix)


def forward_arrays(res, prefix: str) -> dict:
    return {prefix + "ids": torch.stack([r.ids for r in res]).numpy(),
            prefix + "vals": torch.stack([r.values for r in res]).numpy()}


def same_forward(got, want) -> bool:
    return all(torch.equal(g.ids, w.ids) and torch.equal(g.values, w.values)
               for g, w in zip(got, want, strict=True))


def same_reverse(got, want) -> bool:
    """Predictions and the plan counters bitwise (the packing counters
    belong to a ticket's dispatch, not to the query)."""
    return all(torch.equal(g.predictions, w.predictions)
               and all(torch.equal(getattr(g.stats, f), getattr(w.stats, f))
                       for f in PLAN)
               for g, w in zip(got, want, strict=True))


def answers(tickets) -> list:
    return [t.result(timeout=WAIT) for t in tickets]


def submit_from_threads(jobs) -> list:
    """Run each (submit, rows) job in a thread of its own, one ticket a
    row; each job's tickets in row order."""
    out = [[None] * len(rows) for _, rows in jobs]

    def send(j):
        submit, rows = jobs[j]
        for i, row in enumerate(rows):
            out[j][i] = submit(row)

    threads = [threading.Thread(target=send, args=(j,))
               for j in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive(), "a submitter thread hung"
    return out


def wait_until(cond, what: str) -> None:
    end = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < end, what
        time.sleep(0.01)


def serving_checks(policy, art) -> dict:
    """The serving stack under the mesh, on every rank: the forward and
    reverse servers (against the mesh engine, at every rung, on a staged
    version, the refusals), runtimes under the controller rank (threads
    with a linger, warmup, an insert, a delete and a compaction held open
    by a gate while tickets flow, the followers' refusal), and a gateway
    of three tenants on one pool. Flags are the controller's comparisons;
    arrays are every rank's, for the tests to hold."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import ShardingPolicy
    from repro_torch.engine import (IndexArtifact, RetrievalServer,
                                    RkMIPSEngine, ServingGateway,
                                    ServingRuntime, TenantPolicy)
    from repro_torch.engine import controller

    _, _, queries, fwd, inserts, deletes = corpus()
    q, u = torch.from_numpy(queries), torch.from_numpy(fwd)
    users = list(u.unbind(0))
    sart = art.with_config(art.config.replace(**SERVE))
    eng = RkMIPSEngine.from_artifact(sart, policy=policy)
    lead = dist.get_rank() == int(policy.mesh.mesh.flatten()[0])
    out = {}

    # -- the forward server ------------------------------------------------
    srv = eng.server()
    srv.submit(u)
    sync_fwd = srv.flush(K)
    out.update(forward_arrays(sync_fwd, "srv/"))
    km = eng.kmips(u, K)
    out.update({"srv/kmips_ids": km.ids.numpy(),
                "srv/kmips_vals": km.values.numpy()})
    srv.submit(u)
    out.update(forward_arrays(srv.flush(K, n_cand=N), "srv_exact/"))
    out["srv/rungs"] = np.array(all(
        same_forward(srv._flush_batch(users[lo:lo + rung], K, pad_to=rung),
                     sync_fwd[lo:lo + rung])
        for rung in (1, 2) for lo in range(0, len(users), rung)))
    out["srv/builds"] = np.array(srv.cache.builds)
    staged = sart.delete_items(np.r_[0, deletes]).insert_items(inserts)
    s2 = RetrievalServer.from_artifact(staged, policy=policy)
    s2.submit(u)
    sync_staged = s2.flush(K)
    out.update(forward_arrays(sync_staged, "srv_staged/"))
    k2 = RkMIPSEngine.from_artifact(staged, policy=policy).kmips(u, K)
    out.update({"srv_staged/kmips_ids": k2.ids.numpy(),
                "srv_staged/kmips_vals": k2.values.numpy()})
    other = ShardingPolicy(mesh=init_device_mesh(
        "cpu", (policy.device_count,), mesh_dim_names=("data",)))
    out["share_other_mesh"] = np.array(raises(
        ValueError, lambda: RetrievalServer.from_artifact(
            sart, policy=other, share_dispatch=srv)))
    out["share_no_mesh"] = np.array(raises(
        ValueError, lambda: RetrievalServer.from_artifact(
            sart, share_dispatch=srv)))
    out["share_same_mesh"] = np.array(RetrievalServer.from_artifact(
        sart, policy=policy, share_dispatch=srv)._sigs is srv._sigs)

    # -- the reverse server, f32 and int8 ------------------------------------
    sync_rev = {}
    for prec in ("f32", "int8"):
        rs = RkMIPSEngine(sart.config.replace(scan_precision=prec),
                          policy=policy).attach(sart).reverse_server()
        rs.submit(q)
        sync_rev[prec] = rs.flush(K)
        out.update(served_arrays(sync_rev[prec], f"rsrv_{prec}/"))
    budgeted = RkMIPSEngine(sart.config.replace(scan_budget=BUDGET),
                            policy=policy).attach(sart).reverse_server()
    budgeted.submit(q)
    sync_budget = budgeted.flush(K)

    # -- two runtimes under the controller: threads, linger, warmup ----------
    rt_r = RkMIPSEngine.from_artifact(sart, policy=policy) \
        .async_reverse_server(k=K, warmup=True, workers=2,
                              batch_linger=0.005)
    rt_f = RkMIPSEngine.from_artifact(sart, policy=policy).async_server(
        k=K, warmup=True, workers=2, batch_linger=0.005)
    try:
        if lead:
            rev_t, fwd_t = submit_from_threads([(rt_r.submit, list(q)),
                                                (rt_f.submit, users)])
            out["rt/reverse_same"] = np.array(same_reverse(answers(rev_t),
                                                           sync_rev["f32"]))
            out["rt/forward_same"] = np.array(same_forward(answers(fwd_t),
                                                           sync_fwd))
            # a bad k raises on every rank before any collective: the
            # controller's ticket gets the error, each follower counts it
            out["rt/bad_k_error"] = np.array(raises(
                ValueError, lambda: rt_f.submit(u[0], k=10 * N).result(
                    timeout=WAIT)))
        else:
            out["rt/submit_error"] = np.array(raises(
                RuntimeError, lambda: rt_r.submit(q[0])))
        out["rt/drained"] = np.array([rt_r.drain(WAIT), rt_f.drain(WAIT)])
        out["rt/stats"] = np.array([[st.completed, st.failed,
                                     st.traces_after_warmup]
                                    for st in (rt_r.stats, rt_f.stats)])
        out["rt/server_types"] = np.array([type(rt_r.server).__name__,
                                           type(rt_f.server).__name__])
    finally:
        rt_r.close(timeout=WAIT)
        rt_f.close(timeout=WAIT)

    # -- changes and a compaction held open while tickets flow ---------------
    more = (0.9 * inserts[:2]).astype(np.float32)
    started, release = threading.Event(), threading.Event()
    compact = IndexArtifact.compact
    if lead:
        def gated(self, **kw):
            started.set()
            assert release.wait(WAIT)
            return compact(self, **kw)
        IndexArtifact.compact = gated
    rt = ServingRuntime(RkMIPSEngine.from_artifact(
        sart, policy=policy).reverse_server(), k=K, compaction=True,
        compact_fill=1.0, poll_interval=0.01)
    try:
        rt.insert_items(inserts)
        rt.delete_items(deletes)
        rt.request_compaction()
        if lead:
            assert started.wait(WAIT), "the compaction never started"
            answers(rt.submit(q))                 # traffic keeps flowing
            out["gated/held"] = np.array(rt.stats.compactions == 0)
        rt.insert_items(more)                     # ... and so do changes
        # an id past the version raises on every rank, after the stream
        out["gated/bad_delete"] = np.array(raises(
            ValueError, lambda: rt.delete_items([10 * N])))
        if lead:
            release.set()
            wait_until(lambda: rt.stats.compactions >= 1,
                       "the compaction never landed")
            after = answers(rt.submit(q))
        out["gated/drained"] = np.array(rt.drain(WAIT))
        st = rt.stats
        out["gated/counts"] = np.array([st.compactions, st.swaps,
                                        st.completed])
    finally:
        release.set()
        IndexArtifact.compact = compact
        rt.close(timeout=WAIT)
    landed = rt.artifact
    out["gated/fingerprint"] = np.array(landed.fingerprint)
    out["gated/pending"] = np.array([landed.n_base, landed.delta_used])
    out["gated/sharded"] = np.array(landed.build_timings.sharded)
    out.update(index_arrays(landed.index, "gated/"))
    sync = RkMIPSEngine.from_artifact(landed, policy=policy).reverse_server()
    sync.submit(q)
    want = sync.flush(K)
    if lead:
        out["gated/after_same"] = np.array(same_reverse(after, want))

    # -- a gateway of three tenants on one pool ------------------------------
    gw = ServingGateway(pool_workers=2)
    try:
        gw.register("reverse", sart, k=K, sharding=policy)
        gw.register("budgeted", sart, k=K, sharding=policy,
                    policy=TenantPolicy(scan_budget=BUDGET))
        gw.register("forward", sart, k=K, sharding=policy, mode="forward")
        out["gw/shared"] = np.array(
            gw.runtime("budgeted").server.engine._sigs
            is gw.runtime("reverse").server.engine._sigs)
        gw.warmup()
        if lead:
            tickets = [gw.submit("reverse", q), gw.submit("budgeted", q),
                       gw.submit("forward", u)]
            rev, bud, fw = (answers(t) for t in tickets)
            out["gw/same"] = np.array([
                all(same_reverse([g], [w]) and torch.equal(
                    g.stats.tiles_scanned, w.stats.tiles_scanned)
                    for g, w in zip(rev, sync_rev["f32"])),
                same_reverse(bud, sync_budget)
                and [g.truncated for g in bud] == [w.truncated
                                                   for w in sync_budget],
                same_forward(fw, sync_fwd)])
        gw.swap("forward", staged)        # every rank, its own copy
        if lead:
            out["gw/swapped_same"] = np.array(same_forward(
                answers(gw.submit("forward", u)), sync_staged))
        out["gw/drained"] = np.array(gw.drain(WAIT))
        st = gw.stats()
        out["gw/stats"] = np.array(
            [st.traces_after_warmup]
            + [st.tenants[n].completed for n in gw.tenants])
    finally:
        gw.close(timeout=WAIT)
    stream = controller.stream_for(policy)
    wait_until(lambda: not stream.active, "the stream's thread never ended")
    out["stream/ops"] = np.array([stream.sent[op] for op in controller.OPS])
    return out


def rank_main(rank: int, shape: tuple, workdir: str, art_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=math.prod(shape),
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        out = rank_checks(shape, art_dir)
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def kernel_rank_main(rank: int, world: int, workdir: str) -> None:
    """A rank of the card's world: gloo over CUDA tensors, every rank on
    cuda:0. Each rank hashes its slice of seeded rows with ``srp_hash``
    and scores its slice against seeded query codes with the dense
    ``hamming_scores``, holds both against their plain versions, and the
    gathered slices against the whole; writes its verdicts."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.dist import ShardingPolicy
    from repro_torch.dist.collectives import all_gather_cat
    from repro_torch.engine.build import row_parallel
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=world)
    try:
        policy = ShardingPolicy(mesh=init_device_mesh(
            "cuda", (world,), mesh_dim_names=("data",)))
        gen = torch.Generator().manual_seed(SEED)
        dev = torch.device("cuda", 0)
        rows = torch.randn(4099, 101, generator=gen).to(dev)
        proj = torch.randn(101, 128, generator=gen).to(dev)
        qcodes = torch.randint(-2**31, 2**31 - 1, (8, 4), generator=gen,
                               dtype=torch.int32).to(dev)
        ops.reset_launch_counts()
        codes = row_parallel(ops.srp_hash, rows, (proj,), policy=policy)
        n = rows.shape[0]
        per = -(-n // world)
        padded = torch.cat([codes, codes.new_zeros(per * world - n,
                                                   codes.shape[1])])
        mine = padded[rank * per:(rank + 1) * per]
        dist_mine = ops.hamming_scores(qcodes, mine)
        dist_all = all_gather_cat(dist_mine, policy, dim=1)
        out = {"launches": np.array([ops.launch_counts["srp_hash"],
                                     ops.launch_counts["hamming_scores"]]),
               "codes": np.array(torch.equal(codes,
                                             kref.srp_hash(rows, proj))),
               "dist_slice": np.array(torch.equal(
                   dist_mine, kref.hamming_scores(qcodes, mine))),
               "dist_all": np.array(torch.equal(
                   dist_all[:, :n],
                   kref.hamming_scores(qcodes, codes)))}
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_world(name: str, workdir: str, art_dir: str) -> list[dict]:
    """Run world ``name`` once (one process a rank, gloo on the CPU, a
    ``file://`` rendezvous in ``workdir``); returns each rank's arrays."""
    import torch.multiprocessing as mp
    shape = WORLDS[name]
    world = math.prod(shape)
    mp.spawn(rank_main, args=(shape, workdir, art_dir), nprocs=world,
             join=True)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]

"""The rank body of the gloo worlds that tests/test_torch_dist.py spawns.

JAX-free on purpose: ``torch.multiprocessing.spawn`` re-imports this module
in every rank, and a rank runs the port alone. Each world is spawned once
(``spawn_world``); every rank runs ``rank_checks`` under its mesh and
writes what it saw to ``rank<r>.npz``, which the tests hold against the
single-device port and the reference.
"""

from __future__ import annotations

import math
import os

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
    out["server_error"] = np.array(raises(NotImplementedError, eng.server))
    out["mapped_error"] = np.array(raises(
        RuntimeError, lambda: eng.query_batch_mapped(q, K)))
    return out


def rank_main(rank: int, shape: tuple, workdir: str, art_dir: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=math.prod(shape))
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

"""Streaming corpus updates through the index-artifact lifecycle (twin of
``examples/update_stream.py``).

    PYTHONPATH=src python -m repro_torch.examples.update_stream [--device cpu]

The walkthrough of DESIGN.md SS10, insert -> serve -> compact:

1. build an ``IndexArtifact`` over a synthetic catalogue and stand up a
   live ``ReverseServer`` ("which users would see this item in their
   top-k?") from it;
2. a batch of trending items lands: ``insert_items`` stages them in the
   fixed-capacity delta buffer and ``swap`` makes the new version live
   between flushes: pending tickets survive, answers reflect the new rows
   immediately, and the server adds at most ONE dispatch signature (the
   buffer's capacity is a static shape);
3. retire a few items with ``delete_items``: the swap reuses every
   signature (delete-only churn rides the plain pipeline);
4. ``compact()`` folds the stream into fresh norm-ordered partitions: the
   compacted artifact answers bitwise like a cold build on the mutated
   catalogue from the same draws, and ``save``/``load`` round-trips it
   for the next process.
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch import IndexArtifact, RkMIPSEngine, get_config
from repro_torch.data import synthetic
from repro_torch.examples._common import add_flags, check

RETIRED = 8          # lowest-norm catalogue rows retired at v3


def audience(result) -> int:
    return int(result.predictions.sum())


def run(items, users, promoted, trending, *, k: int,
        generator: torch.Generator, device="cuda",
        draws: dict | None = None) -> dict:
    """The walkthrough over (items, users): serve ``promoted`` at v1, after
    staging ``trending`` (v2), after retiring the 8 lowest-norm items (v3)
    and after ``compact`` (v4). The build's draws come from ``generator``
    (a CPU generator); ``draws`` (``key``, ``proj``, ``cone_order``,
    ``kmips_proj``) injects them instead, as the reference's key fixes
    its own. Returns the printed figures."""
    draws = draws or {}
    n_items = items.shape[0]
    inserts = trending.shape[0]
    cfg = get_config("sah").replace(delta_capacity=max(64, inserts),
                                    serve_batch_size=4)
    state = generator.get_state()
    art = IndexArtifact.build(items, users, generator, config=cfg,
                              device=device, **draws)
    eng = RkMIPSEngine.from_artifact(art, device=device)
    server = eng.reverse_server()
    print(f"built v1: {art.n_base} items x {art.n_users} users, "
          f"fingerprint {art.fingerprint[:16]}...")

    # -- serve against the base version -----------------------------------
    server.submit(promoted)
    base = server.flush(k)
    v1 = [audience(r) for r in base]
    print(f"v1: audiences {v1} (compiles={server.compile_count})")

    # -- trending items arrive: stage + hot swap --------------------------
    art_v2 = art.insert_items(trending)
    server.submit(promoted)                      # tickets before the swap
    server.swap(art_v2)                          # ...survive it
    v2r = server.flush(k)
    v2 = [audience(r) for r in v2r]
    print(f"v2 (+{inserts} staged rows): audiences {v2} "
          f"(compiles={server.compile_count}, "
          f"delta buffer {int(art_v2.delta_mask.sum())}"
          f"/{art_v2.delta_capacity})")
    shrink = sum(a < b for a, b in zip(v2, v1))
    print(f"    {shrink}/{len(v1)} promoted items lost audience to the "
          f"staged rows — inserts are live before any rebuild")

    # -- retire the weakest catalogue rows: delete-only churn is free -----
    norms = torch.linalg.norm(items, dim=-1)
    retired = torch.argsort(norms, stable=True)[:RETIRED].tolist()
    art_v3 = art_v2.delete_items(retired)
    server.swap(art_v3)
    server.submit(promoted[0])
    v3 = audience(server.flush(k)[0])
    print(f"v3 (-{len(retired)} retired): audience {v3} "
          f"(compiles={server.compile_count})")

    # -- compact: fold the stream into fresh partitions -------------------
    art_v4 = art_v3.compact()
    server.swap(art_v4)
    ref = RkMIPSEngine(cfg, device=device).build(
        art_v3.effective_items(), users, torch.Generator().set_state(state),
        **{name: v for name, v in draws.items() if name != "key"})
    check_res = RkMIPSEngine.from_artifact(art_v4, device=device) \
        .query_batch(promoted, k)
    truth = ref.query_batch(promoted, k)
    check(torch.equal(check_res.predictions, truth.predictions),
          "the compacted artifact's predictions differ from a cold build's")
    print(f"v4 compacted: {art_v4.n_base} rows, bitwise equal to a cold "
          f"build on the mutated catalogue")

    # -- ship it ----------------------------------------------------------
    with tempfile.TemporaryDirectory() as d:
        art_v4.save(d)
        back = IndexArtifact.load(d, device=device)
        check(back.fingerprint == art_v4.fingerprint,
              "the loaded artifact's fingerprint differs from the saved one")
        print(f"saved + loaded, fingerprint {back.fingerprint[:16]}... "
              f"verified — attach it to any engine, on any mesh")
    return {"fingerprint_v1": art.fingerprint, "audiences_v1": v1,
            "audiences_v2": v2, "audience_v3": v3, "shrink": shrink,
            "compiles": server.compile_count, "n_base_v4": art_v4.n_base,
            "fingerprint_v4": art_v4.fingerprint, "retired": retired,
            "n_items": n_items}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-items", type=int, default=4096)
    ap.add_argument("--m-users", type=int, default=8192)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--inserts", type=int, default=24)
    add_flags(ap)
    args = ap.parse_args(argv)

    gen = torch.Generator().manual_seed(args.seed)
    items, users = synthetic.recommendation_data(
        gen, args.n_items, args.m_users, args.dim, device=args.device)
    promoted = synthetic.queries_from_items(gen, items, 4)
    # make them compete: in-distribution blends of catalogue rows, boosted
    pick = torch.randint(0, args.n_items, (2, args.inserts), generator=gen)
    pick = pick.to(items.device)
    trending = 0.65 * (items[pick[0]] + items[pick[1]])
    return run(items, users, promoted, trending, k=args.k, generator=gen,
               device=args.device)


if __name__ == "__main__":
    main()

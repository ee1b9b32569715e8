"""End-to-end serving driver: two-tower retrieval with SAH-indexed
candidates (twin of ``examples/serve_retrieval.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_retrieval --steps 30 [--device cpu]

1. trains the two-tower model (the smoke-scale config by default) on
   synthetic interactions (in-batch sampled softmax);
2. embeds the item corpus with the item tower, builds the SAH candidate
   index offline (SAT + SRP codes);
3. serves retrieval requests **online through the engine's serving
   subsystem** (``repro_torch.engine.serving.RetrievalServer``, DESIGN.md
   SS8): requests arrive one at a time, are micro-batched into fixed-size
   dispatches of the sketch scan, and compared against the exact
   ``ops.ip_topk`` for recall@k + QPS (wall clock to a device sync).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import RkMIPSEngine, get_config
from repro_torch.configs import base as cfg_base
from repro_torch.core import metrics
from repro_torch.examples._common import (add_flags, feature_ids, sync,
                                          train_two_tower, two_tower_batch)
from repro_torch.kernels import ops
from repro_torch.models import recsys
from repro_torch.train import optimizer as opt_lib

N_CAND = 64          # sketch candidates re-ranked a request


def run(cfg, *, steps: int, corpus: int, batch: int, requests: int,
        k: int, seed: int = 0, device="cuda") -> dict:
    """Train ``cfg``'s two-tower model for ``steps`` steps at ``batch``,
    embed ``corpus`` candidates, build the forward index and serve
    ``requests`` users through ``server()`` against ``ops.ip_topk``. The
    model and features come from a generator on ``device`` seeded
    ``seed``, the build's draws from a CPU one. Returns the printed
    figures, the engine and the arrays a caller checks them on."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = recsys.init_twotower_params(gen, cfg, device=device)
    opt = opt_lib.chain(opt_lib.clip_by_global_norm(1.0),
                        opt_lib.adamw(1e-3))
    t0 = time.time()
    losses = train_two_tower(model, cfg,
                             (two_tower_batch(cfg, gen, batch)
                              for _ in range(steps)), opt)
    train_s = time.time() - t0
    print(f"trained {steps} steps in {train_s:.1f}s, "
          f"final loss {losses[-1]:.3f}")

    # --- offline: embed corpus + build SAH index -------------------------
    with torch.no_grad():
        corpus_feats = feature_ids(gen, cfg.item_embedding.vocab_sizes,
                                   corpus)
        cand_vecs = recsys.item_tower(model, corpus_feats, cfg)
    del corpus_feats
    eng = RkMIPSEngine(get_config("sah").replace(
        n_bits=256, serve_batch_size=min(16, requests)), device=device)
    eng.build(cand_vecs, None, torch.Generator().manual_seed(seed))
    print(f"SAH candidate index built in {eng.build_seconds:.2f}s "
          f"({int(eng.kmips_index.n_parts)} norm partitions)")

    # --- online: batched requests ---------------------------------------
    with torch.no_grad():
        req_feats = feature_ids(gen, cfg.user_embedding.vocab_sizes,
                                requests)
        u = recsys.user_tower(model, req_feats, cfg)
    del model

    ev, ei = ops.ip_topk(u, cand_vecs, k)                # exact
    sync(device)
    t0 = time.time()
    ev, ei = ops.ip_topk(u, cand_vecs, k)
    sync(device)
    t_exact = time.time() - t0

    # Online serving: requests arrive one at a time; the server accumulates
    # them into fixed-size micro-batches (one dispatch signature per batch
    # size) and dispatches the sketch scan (DESIGN.md SS8).
    server = eng.server()
    for i in range(requests):                            # warm
        server.submit(u[i])
    server.flush(k, n_cand=N_CAND)
    compiles_warm = server.compile_count
    t0 = time.time()
    for i in range(requests):
        server.submit(u[i])
    results = server.flush(k, n_cand=N_CAND)
    sync(device)
    t_sah = time.time() - t0

    sids = torch.stack([r.ids for r in results])
    rec = float(metrics.recall_at_k(sids, ei).mean())
    print(f"\nexact : {requests/t_exact:8.0f} QPS")
    print(f"SAH   : {requests/t_sah:8.0f} QPS  recall@{k}={rec:.3f}"
          f"  (micro-batch {server.batch_size}, "
          f"{server.compile_count} compile)")
    return {"losses": losses, "train_s": train_s,
            "build_seconds": eng.build_seconds,
            "n_parts": int(eng.kmips_index.n_parts),
            "exact_qps": requests / t_exact, "sah_qps": requests / t_sah,
            "recall": rec, "batch_size": server.batch_size,
            "compiles_warm": compiles_warm,
            "compiles": server.compile_count, "engine": eng, "users": u,
            "cand_vecs": cand_vecs, "exact_vals": ev, "exact_ids": ei,
            "sah_ids": sids}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--corpus", type=int, default=16384)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--k", type=int, default=20)
    add_flags(ap)
    args = ap.parse_args(argv)

    cfg = cfg_base.get("two-tower-retrieval").make_smoke_config()
    return run(cfg, steps=args.steps, corpus=args.corpus, batch=args.batch,
               requests=args.requests, k=args.k, seed=args.seed,
               device=args.device)


if __name__ == "__main__":
    main()

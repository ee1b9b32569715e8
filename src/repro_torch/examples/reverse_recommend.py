"""The paper's motivating use case, end to end: a service promotes an item
and asks "which users would actually see it?": RkMIPS over two-tower
embeddings (twin of ``examples/reverse_recommend.py``).

    PYTHONPATH=src python -m repro_torch.examples.reverse_recommend [--device cpu]

Pipeline: train two-tower (briefly) -> embed users and items -> build the
full SAH index (item partitions + cone-blocked users + lower bounds) ->
answer reverse queries for promoted items and compare against exact.
Contrast with forward kMIPS on the same queries (Table 2 of the paper:
the two problems' answers barely overlap), whose top-k is the exact
``ops.ip_topk``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import RkMIPSEngine
from repro_torch.configs import base as cfg_base
from repro_torch.core import metrics
from repro_torch.examples._common import (add_flags, feature_ids,
                                          train_two_tower, two_tower_batch)
from repro_torch.kernels import ops
from repro_torch.models import recsys
from repro_torch.train import optimizer as opt_lib

BATCH = 256          # interactions a training step
PROMOTED = 4         # the highest-norm items are promoted


def run(cfg, *, steps: int, n_items: int, m_users: int, k: int,
        seed: int = 0, device="cuda") -> dict:
    """Train ``cfg``'s two-tower model for ``steps`` steps, embed
    ``n_items`` items and ``m_users`` users, and answer the reverse query
    of the 4 highest-norm items beside their forward top-k. The model and
    features come from a generator on ``device`` seeded ``seed``, the
    build's draws from a CPU one. Returns the printed figures and the
    arrays a caller checks them on."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = recsys.init_twotower_params(gen, cfg, device=device)
    losses = train_two_tower(model, cfg,
                             (two_tower_batch(cfg, gen, BATCH)
                              for _ in range(steps)),
                             opt_lib.adamw(1e-3))
    print(f"two-tower trained ({steps} steps, loss {losses[-1]:.3f})")

    with torch.no_grad():
        item_feats = feature_ids(gen, cfg.item_embedding.vocab_sizes,
                                 n_items)
        user_feats = feature_ids(gen, cfg.user_embedding.vocab_sizes,
                                 m_users)
        items = recsys.item_tower(model, item_feats, cfg)
        users = recsys.user_tower(model, user_feats, cfg)
    del model, item_feats, user_feats

    eng = RkMIPSEngine("sah", device=device).build(
        items, users, torch.Generator().manual_seed(seed))
    print(f"SAH index over embeddings built in {eng.build_seconds:.2f}s")

    # promote the 4 highest-norm items
    norms = torch.linalg.norm(items, dim=-1)
    promoted = torch.argsort(-norms, stable=True)[:PROMOTED]
    queries = items[promoted]

    res = eng.query_batch(queries, k)
    po = res.predictions
    truth = eng.oracle(queries, k)
    f1 = metrics.f1_score(po, truth)

    # forward kMIPS top-k users by raw inner product (the wrong tool)
    uu = users / torch.linalg.norm(users, dim=-1, keepdim=True)
    _, fwd_top = ops.ip_topk(queries, uu, k)
    overlaps, audiences = [], []
    for i, item_id in enumerate(promoted.tolist()):
        audience = torch.nonzero(po[i]).flatten()
        fwd = set(fwd_top[i].tolist())
        overlap = len(fwd & set(audience.tolist()))
        overlaps.append(overlap)
        audiences.append(int(audience.numel()))
        print(f"item {item_id}: RkMIPS audience={audience.numel()} users "
              f"(F1 vs exact {float(f1[i]):.3f}); forward-kMIPS top-{k} "
              f"overlaps only {overlap}/{k} -- the reverse problem is "
              f"genuinely different")
    return {"losses": losses, "build_seconds": eng.build_seconds,
            "seconds": res.seconds, "f1": f1.tolist(),
            "audiences": audiences, "overlaps": overlaps,
            "promoted": promoted.tolist(), "items": items,
            "users_unit": uu, "queries": queries, "predictions": po,
            "truth": truth, "fwd_top": fwd_top, "tie_eps":
            eng.config.tie_eps}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--n-items", type=int, default=4096)
    ap.add_argument("--m-users", type=int, default=8192)
    ap.add_argument("--k", type=int, default=10)
    add_flags(ap)
    args = ap.parse_args(argv)

    cfg = cfg_base.get("two-tower-retrieval").make_smoke_config()
    return run(cfg, steps=args.steps, n_items=args.n_items,
               m_users=args.m_users, k=args.k, seed=args.seed,
               device=args.device)


if __name__ == "__main__":
    main()

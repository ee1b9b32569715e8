"""Quickstart: build a SAH engine and answer RkMIPS queries (twin of
``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Generates an MF-like synthetic recommendation dataset (the paper's data
regime), builds the engine from its registry preset (for ``sah``: SAT +
SRP sketches + cone blocking + Simpfer lower bounds), answers reverse
queries for a handful of promoted items, and reports F1 against the exact
oracle plus pruning statistics. Predictions and the oracle share one
EngineConfig, so the tie tolerance can never drift between the two.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import RkMIPSEngine, get_config
from repro_torch.core import metrics
from repro_torch.data import synthetic
from repro_torch.examples._common import add_flags


def run(items, users, queries, *, k: int, method: str = "sah",
        generator: torch.Generator, device="cuda") -> dict:
    """Build ``method``'s engine over (items, users) from ``generator`` (a
    CPU generator), answer ``queries`` at ``k`` and score them against the
    oracle. Returns the printed figures, the predictions and the truth."""
    n, d = items.shape
    nq = queries.shape[0]
    print(f"items={n} users={users.shape[0]} d={d} k={k} method={method}")
    eng = RkMIPSEngine(get_config(method), device=device).build(
        items, users, generator)
    parts, blocks = int(eng.index.alsh.n_parts), eng.index.n_blocks
    print(f"SAH index built in {eng.build_seconds:.2f}s "
          f"(partitions={parts}, cone blocks={blocks})")
    # per-stage breakdown of the staged build pipeline (DESIGN.md SS11)
    print(eng.build_timings.format())

    res = eng.query_batch(queries, k)
    dt = res.seconds / nq

    truth = eng.oracle(queries, k)
    f1 = metrics.f1_score(res.predictions, truth)
    print(f"\nper-query time: {dt*1e3:.1f} ms   mean F1: "
          f"{float(f1.mean()):.3f}")
    # the aggregate pruning funnel the batched plan/execute driver recovers
    # per query: blocks -> users -> scan lanes -> tiles (DESIGN.md SS9)
    print(f"pruning funnel: {res.funnel.format()}")
    audiences = []
    for i in range(nq):
        res_i = torch.nonzero(res.predictions[i]).flatten().tolist()
        audiences.append(len(res_i))
        if i < 4:
            print(f"query {i}: {len(res_i)} users would see this item in "
                  f"their top-{k}: {res_i[:8]}"
                  f"{'...' if len(res_i) > 8 else ''}")
    return {"method": method, "build_seconds": eng.build_seconds,
            "partitions": parts, "cone_blocks": blocks,
            "ms_per_query": dt * 1e3, "seconds": res.seconds,
            "f1_mean": float(f1.mean()), "funnel": res.funnel,
            "audiences": audiences, "predictions": res.predictions,
            "truth": truth}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-items", type=int, default=8192)
    ap.add_argument("--m-users", type=int, default=16384)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--method", default="sah",
                    help="engine registry preset (sah, sa-simpfer, ...)")
    add_flags(ap)
    args = ap.parse_args(argv)

    gen = torch.Generator().manual_seed(args.seed)
    items, users = synthetic.recommendation_data(
        gen, args.n_items, args.m_users, args.dim, device=args.device)
    queries = synthetic.queries_from_items(gen, items, args.queries)
    return run(items, users, queries, k=args.k, method=args.method,
               generator=gen, device=args.device)


if __name__ == "__main__":
    main()

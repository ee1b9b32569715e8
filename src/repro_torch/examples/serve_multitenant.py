"""Multi-tenant gateway: N tenants, one worker pool, one signature set
(twin of ``examples/serve_multitenant.py``).

    PYTHONPATH=src python -m repro_torch.examples.serve_multitenant [--device cpu]

The walkthrough of DESIGN.md SS15:

1. build an artifact and stand up a ``ServingGateway``:
   ``register(name, artifact, policy=TenantPolicy(...))`` binds each
   tenant name to an artifact fingerprint plus admission limits; the
   tenants dispatch through per-tenant runtimes that SHARE one
   ``WorkerPool`` and (same config modulo ``scan_budget``) one dispatch
   signature set (the reference's compiled dispatch);
2. gateway-wide ``warmup()``: each shared signature runs once, then
   ``stats().traces_after_warmup == 0`` across ALL tenants, and stays 0
   under live traffic from every tenant;
3. a budgeted tenant (``TenantPolicy(scan_budget=...)``) gets its deep
   scans truncated *visibly*: the ticket comes back ``truncated=True``
   with a pruning-funnel snapshot, answers stay conservative (never a
   false positive vs. the unbudgeted answer), and
   ``stats().tenants[name].truncated`` attributes the count;
4. admission control: k above ``max_k`` and an unknown tenant are
   rejected with explicit messages, up front;
5. per-tenant lifecycle: churn + hot-swap on one tenant while the other
   keeps serving; the pool skips a locked tenant instead of queueing
   behind it, so maintenance never stalls a neighbor.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch import IndexArtifact, get_config
from repro_torch.data import synthetic
from repro_torch.engine import ServingGateway, TenantPolicy
from repro_torch.examples._common import add_flags, check

BLITZ = 4            # "promo blitz" probes
BLITZ_SEED = 7       # the probes' noise
# lanes a chunk: small relative to the corpus so a scan budget has chunks
# to truncate (see tests/test_gateway.py)
CHUNK = 8


def blitz_probes(items: torch.Tensor) -> torch.Tensor:
    """Noisy copies of the 4 top-norm items pushed onto the corpus's
    max-norm shell: they defeat the O(1) pruning and force deep tile
    scans (``benchmarks/bench_adversarial.py`` crafts these
    systematically)."""
    norms = torch.linalg.norm(items, dim=-1)
    picks = items[torch.argsort(norms, stable=True)[-BLITZ:]]
    noise = torch.randn(picks.shape,
                        generator=torch.Generator().manual_seed(BLITZ_SEED))
    blitz = picks + 0.05 * noise.to(items.device) * \
        torch.linalg.norm(picks, dim=-1, keepdim=True)
    return blitz * (norms.max() / torch.linalg.norm(blitz, dim=-1,
                                                     keepdim=True))


def run(items, users, queries, probes, *, k: int,
        generator: torch.Generator, device="cuda") -> dict:
    """The walkthrough over (items, users): ``queries`` and the blitz
    ``probes`` (``blitz_probes(items)``) from both tenants, admission,
    churn. The build's draws come from ``generator`` (a CPU generator).
    Returns the printed figures and each prod ticket's latency, users to
    scan and chunks."""
    cfg = get_config("sah").replace(delta_capacity=64, serve_batch_size=4,
                                    chunk=CHUNK)
    art = IndexArtifact.build(items, users, generator, config=cfg,
                              device=device)
    print(f"built: {art.n_base} items, fingerprint "
          f"{art.fingerprint[:16]}...")
    out = {}

    with ServingGateway(pool_workers=2) as gw:
        # -- 1. two tenants, one pool, one signature set ------------------
        gw.register("prod", art, k=k,
                    policy=TenantPolicy(max_k=k, max_in_flight=256))
        gw.register("trial", art, k=k,
                    policy=TenantPolicy(max_k=k, scan_budget=1))
        print(f"tenants: {gw.tenants}; trial routes to "
              f"{gw.route('trial')[:16]}...")

        # -- 2. gateway-wide warmup --------------------------------------
        cells = gw.warmup()
        out["warmup_cells"] = cells
        out["traces_after_warmup_0"] = gw.stats().traces_after_warmup
        print(f"warmup: {cells} cells compiled for the shared dispatch; "
              f"traces_after_warmup={out['traces_after_warmup_0']}")

        # -- 3. traffic from both tenants: zero retraces, budget visible -
        mixed = torch.cat([queries, probes])
        prod_tickets = [gw.submit("prod", mixed[i])
                        for i in range(mixed.shape[0])]
        trial = [gw.submit("trial", mixed[i])
                 for i in range(mixed.shape[0])]
        prod = [t.result(timeout=120) for t in prod_tickets]
        trial = [t.result(timeout=120) for t in trial]
        out["prod_latency_ms"] = [t.latency * 1e3 for t in prod_tickets]
        out["prod_scan"] = [(int(r.stats.n_scan), int(r.stats.chunks))
                            for r in prod]
        n_trunc = sum(bool(r.truncated) for r in trial)
        for p, t in zip(prod, trial):
            check(not bool((t.predictions & ~p.predictions).any()),
                  "budget must be conservative")
        st = gw.stats()
        print(f"prod: {st.tenants['prod'].completed} tickets, "
              f"truncated={st.tenants['prod'].truncated}")
        print(f"trial: {st.tenants['trial'].completed} tickets, "
              f"truncated={st.tenants['trial'].truncated} "
              f"({n_trunc} flagged on the tickets themselves)")
        print(f"traces_after_warmup={st.traces_after_warmup} "
              f"(both tenants, live traffic)")
        if n_trunc:
            f = next(r.funnel for r in trial if r.truncated)
            print(f"  a truncated ticket's funnel: {f.format()}")
        out.update(stats=st, n_truncated=n_trunc,
                   traces_after_warmup=st.traces_after_warmup,
                   tickets=len(prod) + len(trial))

        # -- 4. admission control ----------------------------------------
        out["rejected"] = []
        for bad in (lambda: gw.submit("trial", queries[0], k=k + 3),
                    lambda: gw.submit("ghost", queries[0])):
            try:
                bad()
            except (ValueError, KeyError) as e:
                out["rejected"].append(str(e))
                print(f"rejected: {e}")

        # -- 5. per-tenant churn while the neighbor serves ---------------
        art2 = gw.insert_items("prod", queries[:4] * 1.01)
        r = gw.submit("trial", queries[0]).result(timeout=120)
        print(f"prod swapped to {gw.route('prod')[:16]}... "
              f"(v{art2.delta_used} staged rows); trial answered "
              f"meanwhile (k={r.k}, swaps seen by trial: "
              f"{gw.stats().tenants['trial'].swaps})")

    print("gateway closed; all tickets resolved")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-items", type=int, default=2048)
    ap.add_argument("--m-users", type=int, default=512)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--queries", type=int, default=24)
    add_flags(ap)
    args = ap.parse_args(argv)

    gen = torch.Generator().manual_seed(args.seed)
    items, users = synthetic.recommendation_data(
        gen, args.n_items, args.m_users, args.dim, device=args.device)
    queries = synthetic.queries_from_items(gen, items, args.queries)
    return run(items, users, queries, blitz_probes(items), k=args.k,
               generator=gen, device=args.device)


if __name__ == "__main__":
    main()

"""The port's multi-tenant gateway (``repro_torch.engine.gateway``) on the
CPU, at the reference tests' sizes (``tests/test_gateway.py``), with
chunk 8 so that a small scan budget bites.

A tenant's answers are bitwise a dedicated runtime's and the one-shot
engine's; routing follows the live version's fingerprint; tenants whose
configs differ only in ``scan_budget`` share one signature set, and after
a gateway-wide warmup traffic from both adds none; a budget truncates
conservatively and visibly, with the per-ticket flags equal to the
reference's on the same artifact; a budget the scan never reaches is
bitwise no budget; a held tenant never stalls another; admission refuses
with explicit messages; stats are per tenant.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.engine.engine import RkMIPSEngine as JaxEngine
from repro_torch.engine import (RetrievalServer, RkMIPSEngine,
                                ServingGateway, ServingRuntime,
                                TenantPolicy, WorkerPool)
from test_torch_serving import K, reference_pair, workload

WAIT = 60


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    items, users, queries = workload()
    jart, tart = reference_pair(tmp_path_factory.mktemp("gateway"), items,
                                users, chunk=8)
    _, fwd = reference_pair(tmp_path_factory.mktemp("forward"), items, None,
                            chunk=8)
    return dict(items=items, queries=queries, jart=jart, art=tart, fwd=fwd)


def results(tickets):
    return [t.result(timeout=WAIT) for t in tickets]


def submit_each(gw, tenant, queries):
    return [gw.submit(tenant, q) for q in queries]


def test_gateway_answers_match_a_dedicated_runtime_bitwise(flow):
    art, q = flow["art"], flow["queries"]
    ref = RkMIPSEngine.from_artifact(art, device="cpu").query_batch(q, K)
    with RkMIPSEngine.from_artifact(
            art, device="cpu").async_reverse_server(k=K) as dedicated:
        ded = results([dedicated.submit(r) for r in q])
    with ServingGateway(pool_workers=2) as gw:
        gw.register("t", art, k=K)
        got = results(submit_each(gw, "t", q))
    for i, (g, d) in enumerate(zip(got, ded)):
        assert torch.equal(g.predictions, d.predictions)
        assert torch.equal(g.predictions, ref.predictions[i])
        assert int(g.stats.n_scan) == int(ref.stats.n_scan[i])
        assert g.truncated is False and d.truncated is False


def test_routing_follows_fingerprints(flow):
    art, q = flow["art"], flow["queries"]
    with ServingGateway() as gw:
        gw.register("t", art, k=K)
        assert gw.route("t") == art.fingerprint
        art2 = gw.insert_items("t", q[:2])
        assert gw.route("t") == art2.fingerprint != art.fingerprint
        art3 = gw.delete_items("t", [3])
        assert gw.route("t") == art3.fingerprint
        gw.swap("t", art)
        assert gw.route("t") == art.fingerprint
        assert gw.runtime("t").stats.swaps == 3
        assert gw.tenants == ("t",)
        with pytest.raises(KeyError, match="unknown tenant 'ghost'"):
            gw.route("ghost")


def test_shared_signatures_add_nothing_after_warmup(flow):
    """A budgeted and an unbudgeted reverse tenant share one signature
    set, and so do two forward tenants over other corpora; a reverse
    tenant of another recipe gets its own; after one gateway warmup,
    traffic from every tenant adds nothing."""
    art, q = flow["art"], flow["queries"]
    other = RkMIPSEngine(flow["fwd"].config, device="cpu").build(
        flow["items"][::-1].copy(), None)
    with ServingGateway(pool_workers=2) as gw:
        a = gw.register("plain", art, k=K)
        b = gw.register("budgeted", art, k=K,
                        policy=TenantPolicy(scan_budget=2))
        c = gw.register("fwd", flow["fwd"], k=K)
        d = gw.register("fwd2", other.artifact, k=K)
        assert b.server.engine._sigs is a.server.engine._sigs
        assert d.server._sigs is c.server._sigs
        e = gw.register("recipe", RkMIPSEngine(
            art.config.replace(n_cand=8), device="cpu").build(
                flow["items"], flow["items"][:40]).artifact, k=K)
        assert e.server.engine._sigs is not a.server.engine._sigs
        assert gw.warmup() > 0
        assert gw.stats().traces_after_warmup == 0
        tickets = []
        for r in q:
            for name in ("plain", "budgeted", "fwd", "fwd2", "recipe"):
                tickets.append(gw.submit(name, r))
        results(tickets)
        st = gw.stats()
        assert st.traces_after_warmup == 0
        for name in ("plain", "budgeted", "fwd", "fwd2", "recipe"):
            assert st.tenants[name].traces_after_warmup == 0


def test_budget_truncation_is_conservative_and_flagged(flow):
    """Budget 1 with chunk 8: truncated tickets are flagged, their answers
    a subset of the unbudgeted ones, untruncated tickets exact; the
    tenant's stats count them; the plain tenant has none."""
    art, q = flow["art"], flow["queries"]
    ref = RkMIPSEngine.from_artifact(art, device="cpu").query_batch(q, K)
    with ServingGateway(pool_workers=2) as gw:
        gw.register("plain", art, k=K)
        gw.register("tight", art, k=K, policy=TenantPolicy(scan_budget=1))
        plain = results(submit_each(gw, "plain", q))
        tight = results(submit_each(gw, "tight", q))
        st = gw.stats()
    flagged = [r for r in tight if r.truncated]
    assert flagged, "budget 1 must truncate something here"
    for i, r in enumerate(tight):
        full = ref.predictions[i]
        assert not bool((r.predictions & ~full).any())
        if r.truncated:
            assert int(r.stats.tiles_scanned) >= 1
        else:
            assert torch.equal(r.predictions, full)
    for r in flagged:
        assert r.funnel.truncated > 0
        assert "budget-truncated" in r.funnel.format()
    assert st.tenants["tight"].truncated == len(flagged)
    assert st.tenants["plain"].truncated == 0
    assert not any(r.truncated for r in plain)


@pytest.mark.parametrize("budget", [1, 2])
def test_truncation_flags_equal_the_references(flow, budget):
    """The same artifact through both packages' synchronous reverse
    servers (the same micro-batches) under one budget: the per-ticket
    ``truncated`` flags and tile counts are the reference's, and the
    predictions too."""
    art, jart, q = flow["art"], flow["jart"], flow["queries"]
    cfg = art.config.replace(scan_budget=budget)
    srv = RkMIPSEngine(cfg, device="cpu").attach(art).reverse_server()
    jsrv = JaxEngine(jart.config.replace(scan_budget=budget)).attach(
        jart).reverse_server()
    srv.submit(q)
    jsrv.submit(jnp.asarray(q))
    got, want = srv.flush(K), jsrv.flush(K)
    assert any(r.truncated for r in got)
    for g, w in zip(got, want):
        assert g.truncated is w.truncated
        assert int(g.stats.tiles_scanned) == int(w.stats.tiles_scanned)
        assert int(g.stats.truncated) == int(w.stats.truncated)
        np.testing.assert_array_equal(g.predictions.numpy(),
                                      np.asarray(w.predictions))


def test_a_budget_never_reached_is_no_budget(flow):
    art, q = flow["art"], flow["queries"]
    ref = RkMIPSEngine.from_artifact(art, device="cpu").query_batch(q, K)
    for budget in (0, 10_000):
        eng = RkMIPSEngine(art.config.replace(scan_budget=budget),
                           device="cpu").attach(art)
        res = eng.query_batch(q, K)
        assert torch.equal(res.predictions, ref.predictions)
        for a, b in zip(res.stats, ref.stats):
            assert torch.equal(a, b)
        assert int(res.stats.truncated.sum()) == 0


def test_a_held_tenant_never_stalls_another(flow):
    art, q = flow["art"], flow["queries"]
    with ServingGateway(pool_workers=1) as gw:
        a = gw.register("a", art, k=K)
        gw.register("b", art, k=K)
        assert a._dispatch_lock.acquire(timeout=10)
        try:
            results(submit_each(gw, "b", q[:4]))
            ta = gw.submit("a", q[0])
            time.sleep(0.05)
            assert not ta.done()
        finally:
            a._dispatch_lock.release()
        ta.result(timeout=WAIT)


def test_compaction_of_one_tenant_does_not_stall_another(flow):
    art, q = flow["art"], flow["queries"]
    with ServingGateway(pool_workers=1) as gw:
        gw.register("churny", art, k=K, compaction=True, compact_fill=0.2,
                    poll_interval=0.01)
        gw.register("steady", art, k=K)
        gw.insert_items("churny", q[:3])
        gw.request_compaction("churny")
        end = time.monotonic() + WAIT
        # steady is served at least once after the request, however soon
        # the compaction lands (it may land before a first check)
        while True:
            gw.submit("steady", q[0]).result(timeout=WAIT)
            if gw.runtime("churny").stats.compactions >= 1:
                break
            assert time.monotonic() < end, "compaction never landed"
            time.sleep(0.01)
        st = gw.stats()
        assert st.tenants["steady"].completed >= 1
        assert st.tenants["steady"].compactions == 0
        assert gw.runtime("churny").artifact.n_base == art.n_base + 3
        r1 = gw.submit("churny", q[1]).result(timeout=WAIT)
        r2 = gw.submit("steady", q[1]).result(timeout=WAIT)
        assert r1.k == r2.k == K


def test_policy_rejections(flow):
    art, q = flow["art"], flow["queries"]
    with ServingGateway() as gw:
        gw.register("t", art, k=K,
                    policy=TenantPolicy(max_k=4, max_in_flight=2))
        with pytest.raises(KeyError, match="unknown tenant 'ghost'"):
            gw.submit("ghost", q[0])
        with pytest.raises(ValueError, match=r"k=6 exceeds policy max_k=4"):
            gw.submit("t", q[0], k=6)
        with pytest.raises(ValueError, match="already registered"):
            gw.register("t", art, k=K)
        rt = gw.runtime("t")
        assert rt._dispatch_lock.acquire(timeout=10)
        try:
            held = submit_each(gw, "t", q[:2])
            with pytest.raises(RuntimeError, match=r"max_in_flight=2"):
                gw.submit("t", q[2])
        finally:
            rt._dispatch_lock.release()
        results(held)
        gw.submit("t", q[2]).result(timeout=WAIT)


def test_register_validation(flow):
    art, fwd = flow["art"], flow["fwd"]

    class Policy:
        mesh = object()

    with ServingGateway() as gw:
        with pytest.raises(ValueError, match="mode='reverse' needs"):
            gw.register("r", fwd, k=K, mode="reverse")
        with pytest.raises(ValueError, match="scan_budget is a "
                                             "reverse-pipeline knob"):
            gw.register("f", fwd, k=K, policy=TenantPolicy(scan_budget=4))
        with pytest.raises(ValueError, match="pool"):
            gw.register("p", art, k=K, pool=None)
        with pytest.raises(ValueError, match="mode must be"):
            gw.register("m", art, k=K, mode="sideways")
        # a mesh must be a torch DeviceMesh over the world (the mesh
        # tenants themselves run in tests/test_torch_dist.py's worlds)
        with pytest.raises(TypeError, match="needs a torch DeviceMesh"):
            gw.register("s", art, k=K, sharding=Policy())
    with pytest.raises(RuntimeError, match="gateway is closed"):
        gw.register("late", art, k=K)
    with pytest.raises(ValueError, match="max_k must be >= 1"):
        TenantPolicy(max_k=0)
    with pytest.raises(ValueError, match="max_in_flight must be >= 1"):
        TenantPolicy(max_in_flight=0)
    with pytest.raises(ValueError, match="scan_budget must be >= 0"):
        TenantPolicy(scan_budget=-1)


def test_forward_tenant_serves_through_the_pool(flow):
    """mode='auto' on a users=None artifact is a forward tenant; its
    pooled answers are bitwise the synchronous flush."""
    fwd, q = flow["fwd"], flow["queries"]
    sync = RetrievalServer.from_artifact(fwd)
    sync.submit(q)
    want = sync.flush(K)
    with ServingGateway(pool_workers=2) as gw:
        rt = gw.register("fwd", fwd, k=K)
        assert type(rt.server) is RetrievalServer
        got = results(submit_each(gw, "fwd", q))
    for g, w in zip(got, want):
        assert torch.equal(g.ids, w.ids) and torch.equal(g.values, w.values)


def test_stats_are_per_tenant(flow):
    art, q = flow["art"], flow["queries"]
    with ServingGateway(pool_workers=2) as gw:
        gw.register("a", art, k=K)
        gw.register("b", art, k=K)
        results(submit_each(gw, "a", q[:8]) + submit_each(gw, "b", q[:3]))
        assert gw.drain(timeout=WAIT)
        st = gw.stats()
    assert st.tenants["a"].submitted == st.tenants["a"].completed == 8
    assert st.tenants["b"].submitted == st.tenants["b"].completed == 3
    assert st.tenants["a"].failed == st.tenants["b"].failed == 0


def test_pooled_runtimes_compose_and_close_alone(flow):
    """Two plain runtimes on one ``WorkerPool`` answer as dedicated
    workers do; closing one leaves the pool serving the other."""
    art, q = flow["art"], flow["queries"]
    ref = RkMIPSEngine.from_artifact(art, device="cpu").query_batch(q[:4], K)
    with WorkerPool(2) as pool:
        rts = [ServingRuntime(RkMIPSEngine.from_artifact(
            art, device="cpu").reverse_server(), k=K, pool=pool)
            for _ in range(2)]
        try:
            got = [results([rt.submit(r) for r in q[:4]]) for rt in rts]
            rts[0].close(timeout=WAIT)
            assert rts[1].submit(q[0]).result(timeout=WAIT).k == K
            with pytest.raises(RuntimeError, match="closed"):
                rts[0].submit(q[0])
        finally:
            for rt in rts:
                rt.close(timeout=WAIT)
    for answers in got:
        for i, r in enumerate(answers):
            assert torch.equal(r.predictions, ref.predictions[i])

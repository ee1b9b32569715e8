"""The port's servers (``repro_torch.engine.serving``, the flat scan of
``engine/sharding.py`` and the engine's serving surface) held against the
JAX reference on the CPU.

The reference builds each artifact and saves it; the port loads the save,
so both packages serve the same content. Then:

* the flat scan (``kmips_flat_arrays``) and ``RetrievalServer`` give the
  reference's ids but where a difference traces to a float tie
  (``test_torch_kmips.traced_differences``), values allclose at rtol 1e-5,
  atol 1e-6, with and without staged changes; ``ReverseServer`` gives the
  reference's predictions (differences traced, ``test_torch_artifact.
  assert_predictions_traced``) and plan counters;
* inside the port, bitwise: micro-batched answers equal the one-shot
  batch and the single-query path, and every rung of the bucket ladder
  equals the full batch, for both servers with staged changes live;
* the cache's LRU and ``builds`` count, tickets kept on a failed flush,
  the validation messages, one signature per (rung, k) in
  ``compile_count``, warmup leaving nothing to add, and
  ``serving_codes`` against the reference's.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sa_alsh as jalsh
from repro.core import srp as jsrp
from repro.dist.policy import NO_SHARDING
from repro.engine import config as jconfig
from repro.engine import sharding as jsharding
from repro.engine.artifact import KMIPS_KEY_TAG
from repro.engine.artifact import IndexArtifact as JaxArtifact
from repro.engine.engine import RkMIPSEngine as JaxEngine
from repro.engine.engine import serving_codes as jax_serving_codes
from repro.engine.serving import RetrievalServer as JaxServer
from repro_torch.engine import (IndexArtifact, RetrievalServer,
                                RkMIPSEngine, ServingCache,
                                build_serving_state, get_config,
                                serving_codes, sharding)
from repro_torch.kernels import ops
from test_torch_artifact import assert_predictions_traced, trace_arrays
from test_torch_core import assert_codes_close, mf_data
from test_torch_kmips import traced_differences

N, M, D = 120, 64, 16
CFG = dict(tile=32, n_bits=32, k_max=8, n_top=8, leaf_size=8, n_cand=16,
           delta_capacity=8, serve_batch_size=4, serve_buckets=(1, 2))
KEY = jax.random.PRNGKey(31)
K = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def workload(seed=23):
    """MF-like items (n 120) and users (m 64), d 16, and 12 queries: rows
    of the top 20% of items by norm, scaled by 0.9 to 1.1."""
    items, users = mf_data(seed, N, M, D)
    rng = np.random.default_rng(seed)
    order = np.argsort(-np.linalg.norm(items, axis=1), kind="stable")
    queries = items[order[rng.choice(24, 12, replace=False)]] \
        * rng.uniform(0.9, 1.1, (12, 1))
    return items, users, queries.astype(np.float32)


def change(art, rows):
    """The catalogue change every file applies, the same calls in both
    packages: two base rows and a staged row deleted, three rows staged."""
    return art.delete_items([0, 7]).insert_items(rows).delete_items([N + 1])


def staged_rows(items, seed=5):
    rng = np.random.default_rng(seed)
    return (items[:3] * 1.3 + 0.1 * rng.standard_normal((3, D))).astype(
        np.float32)


def reference_pair(root, items, users, **overrides):
    """The reference's artifact over (items, users or None) with CFG and
    ``overrides`` (its forward index built), and the port's load of its
    save from ``root``."""
    jcfg = jconfig.get_config("sah").replace(**{**CFG, **overrides})
    jart = JaxArtifact.build(jnp.asarray(items),
                             None if users is None else jnp.asarray(users),
                             KEY, config=jcfg)
    jart.ensure_kmips_index()
    jart.save(str(root))
    return jart, IndexArtifact.load(str(root), device="cpu")


def kmips_proj():
    return np.array(jsrp.make_projection(
        jax.random.fold_in(KEY, KMIPS_KEY_TAG), D + 1, CFG["n_bits"]))


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    items, users, queries = workload()
    rows = staged_rows(items)
    jart, tart = reference_pair(tmp_path_factory.mktemp("serving"), items,
                                users)
    return dict(items=items, users=users, queries=queries, rows=rows,
                jart=jart, tart=tart, jart2=change(jart, jnp.asarray(rows)),
                tart2=change(tart, rows))


def every_row(flow, changed):
    """Rows by item id: the base items, then the staged buffer."""
    if not changed:
        return flow["items"]
    return np.concatenate([flow["items"],
                           flow["tart2"].delta_items.numpy()])


def assert_forward_traced(flow, changed, got_ids, want_ids, got_vals,
                          want_vals, queries=None):
    queries = flow["queries"] if queries is None else queries
    n = traced_differences(every_row(flow, changed), queries, kmips_proj(),
                           np.asarray(got_ids), np.asarray(want_ids))
    assert n <= 0.05 * np.asarray(got_ids).size
    np.testing.assert_allclose(np.asarray(got_vals), np.asarray(want_vals),
                               rtol=1e-5, atol=1e-6)


def stack(results, field):
    return torch.stack([getattr(r, field) for r in results])


# -- the flat scan ------------------------------------------------------------


@pytest.mark.parametrize("scan", ["sketch", "exact"])
@pytest.mark.parametrize("k", [1, 5])
def test_flat_scan_matches_reference(flow, scan, k):
    """On the same forward index and the same query codes (the
    reference's), ``kmips_flat_arrays`` gives the reference's ids but for
    traced float ties, values allclose."""
    jidx, tidx = flow["jart"].kmips_index, flow["tart"].kmips_index
    q = flow["queries"]
    juc = np.array(jalsh.user_codes(jidx, jnp.asarray(q)))
    want_v, want_i = jsharding.kmips_flat_arrays(
        jidx.items, jidx.item_ids, jidx.item_mask, jidx.codes,
        jnp.asarray(juc), jnp.asarray(q), k, NO_SHARDING, n_cand=16,
        scan=scan)
    ucodes = torch.from_numpy(juc.view(np.int32)) if scan == "sketch" \
        else None
    got_v, got_i = sharding.kmips_flat_arrays(
        tidx.items, tidx.item_ids, tidx.item_mask, tidx.codes, ucodes,
        torch.from_numpy(q), k, n_cand=16, scan=scan)
    assert got_i.dtype == torch.int32 and got_v.shape == (12, k)
    assert_forward_traced(flow, False, got_i, want_i, got_v, want_v)


@pytest.mark.parametrize("n,shards,k", [(97, 3, 5), (53, 7, 2), (64, 5, 1)])
def test_pad_item_rows_is_invisible(n, shards, k):
    """Dead padding rows change no answer, bitwise, under both scans."""
    from repro_torch.core import sa_alsh
    items, _ = mf_data(n, n, 8, 12)
    g = torch.Generator().manual_seed(n)
    idx = sa_alsh.build_index(torch.from_numpy(items), g, n_bits=32,
                              tile=32)
    q = torch.randn(3, 12, generator=g)
    uc = sa_alsh.user_codes(idx, q)
    padded = sharding.pad_item_rows(idx.items, idx.item_ids, idx.item_mask,
                                    idx.codes, shards, k)
    assert padded[0].shape[0] % shards == 0
    assert padded[0].shape[0] // shards >= k
    for scan in ("sketch", "exact"):
        want = sharding.kmips_flat_arrays(
            idx.items, idx.item_ids, idx.item_mask, idx.codes, uc, q, k,
            n_cand=256, scan=scan)
        got = sharding.kmips_flat_arrays(*padded, uc, q, k, n_cand=256,
                                         scan=scan)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_flat_scan_refuses_a_mesh(flow):
    """The flat scan shards over a torch ``DeviceMesh`` (tests/
    test_torch_dist.py); any other mesh object is refused."""
    class Policy:
        mesh = object()
    idx = flow["tart"].kmips_index
    with pytest.raises(TypeError, match="DeviceMesh"):
        sharding.kmips_flat(idx, torch.from_numpy(flow["queries"]), 3,
                            Policy())


# -- the servers against the reference ----------------------------------------


@pytest.mark.parametrize("changed", [False, True])
def test_retrieval_server_matches_reference(flow, changed):
    """The port's and the reference's servers over one artifact (with or
    without staged changes): the same ids but for traced ties."""
    jart = flow["jart2"] if changed else flow["jart"]
    tart = flow["tart2"] if changed else flow["tart"]
    q = flow["queries"]
    jsrv = JaxServer.from_artifact(jart)
    jsrv.submit(jnp.asarray(q))
    want = jsrv.flush(K)
    srv = RetrievalServer.from_artifact(tart)
    assert srv.cache.builds == 0               # seeded from the artifact
    assert srv.submit(q) == list(range(12)) and srv.pending == 12
    got = srv.flush(K)
    assert len(got) == 12 and srv.pending == 0
    assert_forward_traced(flow, changed, stack(got, "ids"),
                          np.stack([np.asarray(r.ids) for r in want]),
                          stack(got, "values"),
                          np.stack([np.asarray(r.values) for r in want]))
    if changed:
        ids = stack(got, "ids")
        assert not bool(torch.isin(ids, torch.tensor([0, 7, N + 1])).any())


@pytest.mark.parametrize("changed", [False, True])
def test_reverse_server_matches_reference(flow, changed):
    jart = flow["jart2"] if changed else flow["jart"]
    tart = flow["tart2"] if changed else flow["tart"]
    q = flow["queries"]
    jsrv = JaxEngine.from_artifact(jart).reverse_server()
    jsrv.submit(jnp.asarray(q))
    want = jsrv.flush(K)
    srv = RkMIPSEngine.from_artifact(tart, device="cpu").reverse_server()
    srv.submit(q)
    got = srv.flush(K)
    view, arrays = trace_arrays(tart)
    assert_predictions_traced(
        arrays, view, q, K, np.stack([np.asarray(r.predictions)
                                      for r in want]),
        stack(got, "predictions"))
    for g, w in zip(got, want):
        for f in ("blocks_alive", "users_alive", "n_no_lb", "n_yes_norm",
                  "n_scan"):
            assert int(getattr(g.stats, f)) == int(getattr(w.stats, f)), f
        assert g.truncated is w.truncated is False
        assert g.funnel.queries == 4


# -- micro-batching, rungs and warmup, inside the port ------------------------


def test_microbatch_bitwise_equals_oneshot(flow):
    """Forward: 12 tickets in micro-batches of 4 equal the one-shot flat
    scan of all 12 and the single-query path, bitwise. Reverse: each
    ticket equals its row of one 12-query ``query_batch``."""
    tart, q = flow["tart"], flow["queries"]
    srv = RetrievalServer.from_artifact(tart)
    state = srv.cache.get(srv.config)
    qt = torch.from_numpy(q)
    v0, i0 = sharding.kmips_flat_arrays(
        state.items, state.item_ids, state.item_mask, state.codes,
        ops.srp_hash(qt, state.proj_q), qt, K, n_cand=16)
    srv.submit(q)
    res = srv.flush(K)
    assert torch.equal(stack(res, "ids"), i0)
    assert torch.equal(stack(res, "values"), v0)
    one = srv.kmips(q[2], K)
    assert torch.equal(one.ids, i0[2]) and torch.equal(one.values, v0[2])
    with pytest.raises(ValueError, match="kmips serves one query"):
        srv.kmips(q[:3], K)

    eng = RkMIPSEngine.from_artifact(tart, device="cpu")
    ref = eng.query_batch(q, K)
    rsrv = eng.reverse_server()
    rsrv.submit(q)
    for i, r in enumerate(rsrv.flush(K)):
        assert torch.equal(r.predictions, ref.predictions[i])
        assert int(r.stats.n_scan) == int(ref.stats.n_scan[i])
        assert r.k == K
    one = rsrv.rkmips(q[5], K)
    assert torch.equal(one.predictions, ref.predictions[5])


def test_with_config_rewires_serving_knobs_only(flow):
    """``with_config`` shares the built pieces under new serving knobs;
    the servers answer as on the original; a knob a built array depends
    on is refused."""
    tart, q = flow["tart2"], flow["queries"]
    cfg = tart.config.replace(serve_batch_size=8, serve_buckets=(1, 2, 4),
                              serve_cache_capacity=2)
    art = tart.with_config(cfg)
    assert art.config == cfg and art.n_items == tart.n_items
    assert art.index is tart.index and art.items is tart.items
    assert art.delta_items is tart.delta_items
    assert art.fingerprint != tart.fingerprint
    assert tart.with_config(tart.config).fingerprint == tart.fingerprint
    want, got = (RetrievalServer.from_artifact(a) for a in (tart, art))
    for srv in (want, got):
        srv.submit(q)
    for w, g in zip(want.flush(K), got.flush(K)):
        assert torch.equal(w.ids, g.ids) and torch.equal(w.values, g.values)
    for bad in (dict(n_cand=8), dict(delta_capacity=16)):
        with pytest.raises(ValueError, match=r"needs a rebuild"):
            tart.with_config(tart.config.replace(**bad))


@pytest.mark.parametrize("mode", ["forward", "reverse"])
def test_every_rung_equals_the_full_batch_with_staged_rows(flow, mode):
    """Bucket padding is dead: each rung of the ladder (1, 2, 4) answers
    every group bitwise as the full-batch flush, with staged changes
    live; after ``warmup`` no rung adds a dispatch signature."""
    tart, q = flow["tart2"], flow["queries"]
    srv = (RetrievalServer.from_artifact(tart) if mode == "forward" else
           RkMIPSEngine.from_artifact(tart, device="cpu").reverse_server())
    assert srv._ladder() == (1, 2, 4)
    assert [srv.bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
    with pytest.raises(ValueError, match=r"group of 5 outside \[1, "
                                         r"batch_size=4\]"):
        srv.bucket_for(5)
    cells = srv.warmup([K])
    # forward: scan + delta merge a rung; reverse: the live buffer a rung
    assert cells == 6 if mode == "forward" else cells == 3
    warm = srv.compile_count
    srv.submit(q)
    full = srv.flush(K)
    rows = [torch.from_numpy(r) for r in q]
    for rung in (1, 2, 4):
        for lo in range(0, 12, rung):
            n = min(rung, 3) if rung == 4 else rung     # 3 pads to 4
            got = srv._flush_batch(rows[lo:lo + n], K, pad_to=rung)
            for j, r in enumerate(got):
                want = full[lo + j]
                if mode == "forward":
                    assert torch.equal(r.ids, want.ids)
                    assert torch.equal(r.values, want.values)
                else:
                    assert torch.equal(r.predictions, want.predictions)
    assert srv.compile_count == warm


def test_reverse_warmup_covers_the_first_insert(flow):
    """Warmup on a version with no staged row runs the empty buffer's
    signature too, so the first insert adds none."""
    eng = RkMIPSEngine.from_artifact(flow["tart"], device="cpu")
    srv = eng.reverse_server()
    assert srv.warmup([K]) == 6                  # 3 rungs x (none, empty)
    warm = srv.compile_count
    srv.swap(flow["tart"].insert_items(flow["rows"][:1]))
    srv.submit(flow["queries"][:4])
    srv.flush(K)
    assert srv.compile_count == warm


# -- the cache ----------------------------------------------------------------


def test_cache_lru_and_builds(flow):
    """A hit returns the same state and counts no build; configs that
    differ only in serving or query knobs share one entry; the least
    recently used entry is evicted; ``put`` counts no build; a rebuild of
    an evicted recipe gives the same codes (the generator's state is
    kept)."""
    items = flow["items"]
    cfg = get_config("sah").replace(**CFG)
    cache = ServingCache(items, np.asarray(KEY),
                         generator=torch.Generator().manual_seed(21),
                         capacity=2, device="cpu")
    a, b, c = cfg, cfg.replace(n_bits=64), cfg.replace(n_bits=96)
    sa = cache.get(a)
    assert cache.builds == 1 and cache.get(a) is sa and cache.builds == 1
    assert cache.get(a.replace(n_cand=8, serve_batch_size=2,
                               serve_cache_capacity=9)) is sa
    cache.get(b)
    assert cache.get(a) is sa                  # refreshes a
    sc = cache.get(c)                          # evicts b, not a
    assert len(cache) == 2 and cache.builds == 3
    assert a in cache and c in cache and b not in cache
    sb = cache.get(b)                          # evicts a, the LRU
    assert cache.builds == 4 and a not in cache and c in cache
    cache.put(a, sa)                           # evicts c; no build
    assert cache.builds == 4 and len(cache) == 2 and c not in cache
    assert cache.get(a) is sa and cache.get(b) is sb
    again = cache.get(c)                       # rebuilt: the same codes
    assert cache.builds == 5 and again is not sc
    assert torch.equal(again.codes, sc.codes) and sb.codes.shape[1] == 2
    fresh = build_serving_state(items, b, generator=torch.Generator()
                                .manual_seed(21), device="cpu")
    assert torch.equal(fresh.codes, sb.codes)
    with pytest.raises(ValueError, match=r"capacity must be >= 1"):
        ServingCache(items, np.asarray(KEY), capacity=0, device="cpu")
    one = ServingCache(items, np.asarray(KEY), proj=kmips_proj(),
                       device="cpu")
    with pytest.raises(ValueError, match=r"no projection for n_bits=64"):
        one.get(b)


def test_server_states_are_the_artifact_index(flow):
    """A server seeded from the artifact scans its forward index's codes;
    one that builds its own from the same projection builds the same
    arrays; padded rows are dead."""
    tart = flow["tart"]
    srv = RetrievalServer.from_artifact(tart)
    seeded = srv.cache.get(srv.config)
    assert srv.cache.builds == 0 and seeded.codes is tart.kmips_index.codes
    raw = RetrievalServer(flow["items"], tart.key, config=tart.config,
                          proj=tart.kmips_proj, device="cpu")
    built = raw.cache.get(raw.config)
    assert raw.cache.builds == 1
    for name in ("items", "item_ids", "item_mask", "codes", "proj_q"):
        assert torch.equal(getattr(built, name), getattr(seeded, name))
    ids = built.item_ids[built.item_mask].sort().values
    assert torch.equal(ids, torch.arange(N, dtype=torch.int32))
    assert bool((built.item_ids[~built.item_mask] == -1).all())
    assert built.n_items == N
    assert raw.cache.fingerprint != srv.cache.fingerprint  # raw vs base


# -- tickets, validation, signatures ------------------------------------------


def test_flush_failures_keep_tickets(flow):
    tart, q = flow["tart"], flow["queries"]
    srv = RetrievalServer.from_artifact(tart)
    assert srv.flush(K) == []
    srv.submit(q[:2])
    with pytest.raises(ValueError, match=rf"k={N + 1} outside \[1, {N}\]"):
        srv.flush(N + 1)
    assert srv.pending == 2
    assert len(srv.flush(K)) == 2 and srv.pending == 0
    srv.config = srv.config.replace(serve_batch_size=2, serve_buckets=())
    assert srv.batch_size == 2
    srv.submit(q[:3])
    assert len(srv.flush(K)) == 3

    rsrv = RkMIPSEngine.from_artifact(tart, device="cpu").reverse_server()
    assert rsrv.flush(K) == []
    rsrv.submit(q[:2])
    with pytest.raises(ValueError, match=r"outside \[1, k_max=8\]"):
        rsrv.flush(9)
    assert rsrv.pending == 2
    assert len(rsrv.flush(K)) == 2 and rsrv.pending == 0
    with pytest.raises(ValueError, match=r"rkmips serves one query"):
        rsrv.rkmips(q[:2], K)
    with pytest.raises(RuntimeError, match=r"not built for RkMIPS"):
        rsrv.swap(IndexArtifact.build(flow["items"], None,
                                      config=tart.config, device="cpu"))


def test_submit_validates_queries_up_front(flow):
    srv = RetrievalServer.from_artifact(flow["tart"])
    with pytest.raises(ValueError, match=r"submit: queries must have a "
                                         r"floating dtype, got int32"):
        srv.submit(np.ones((2, D), np.int32))
    with pytest.raises(ValueError, match=r"submit: queries must be one row "
                                         r"\(d,\) or a block \(nq, d\), "
                                         r"got shape \(2, 3, 16\)"):
        srv.submit(np.ones((2, 3, D), np.float32))
    with pytest.raises(ValueError, match=r"submit: query dimensionality 15 "
                                         r"!= corpus dimensionality 16"):
        srv.submit(np.ones((15,), np.float32))
    assert srv.pending == 0
    rsrv = RkMIPSEngine.from_artifact(flow["tart"],
                                      device="cpu").reverse_server()
    with pytest.raises(ValueError, match=r"floating dtype"):
        rsrv.submit(np.ones((2, D), np.int64))
    with pytest.raises(ValueError, match=r"query dimensionality 8 != "
                                         r"corpus dimensionality 16"):
        rsrv.submit(np.ones((8,), np.float32))
    assert rsrv.pending == 0
    with pytest.raises(RuntimeError, match=r"not built for"):
        RkMIPSEngine.from_artifact(IndexArtifact.build(
            flow["items"], None, config=flow["tart"].config,
            device="cpu"), device="cpu").reverse_server()


def test_compile_count_is_one_per_signature(flow):
    """Every flush pads to the batch: one signature per (batch, k), and a
    delete-only swap adds none; the reverse server counts the engine's
    signatures, which a same-size ``query_batch`` shares."""
    tart, q = flow["tart"], flow["queries"]
    srv = RetrievalServer.from_artifact(tart)
    for n in (3, 7, 1):
        srv.submit(q[:n])
        srv.flush(K)
    assert srv.compile_count == 1
    srv.flush(4)
    srv.submit(q[:1])
    srv.flush(4)
    assert srv.compile_count == 2                  # a new k
    srv.swap(tart.delete_items([3]))
    srv.submit(q[:2])
    srv.flush(K)
    assert srv.compile_count == 2
    srv.swap(tart.insert_items(flow["rows"]))
    srv.submit(q[:2])
    srv.flush(K)
    assert srv.compile_count == 3                  # the delta merge
    other = RetrievalServer.from_artifact(tart, share_dispatch=srv)
    other.submit(q[:1])
    other.flush(K)
    assert other.compile_count == srv.compile_count == 3
    with pytest.raises(TypeError, match="share_dispatch"):
        RetrievalServer.from_artifact(tart, share_dispatch=object())

    eng = RkMIPSEngine.from_artifact(tart, device="cpu")
    rsrv = eng.reverse_server()
    for n in (3, 7, 1):
        rsrv.submit(q[:n])
        rsrv.flush(K)
    assert rsrv.compile_count == 1 and rsrv.batch_size == 4
    eng.query_batch(q[:4], K)
    assert eng.rkmips_compile_count == 1


def test_serving_codes_matches_reference(flow):
    """The deprecated shim gives the reference's codes (as int32 bit
    views) but for flips within rounding of 0 of the hashed SAT rows, and
    its query projection. The reference writes its padding's code onto
    the last row (its ``.at[-1]`` wraps), so that row is left out."""
    from repro_torch.core import sa_alsh
    items = flow["items"]
    proj = np.array(jsrp.make_projection(
        jax.random.fold_in(KEY, KMIPS_KEY_TAG), D + 1, 64))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want_codes, want_proj = jax_serving_codes(jnp.asarray(items), KEY,
                                                  n_bits=64)
    with pytest.warns(DeprecationWarning, match="serving_codes is "
                                                "deprecated"):
        codes, proj_q = serving_codes(items, n_bits=64, key=np.asarray(KEY),
                                      kmips_proj=proj, device="cpu")
    assert codes.dtype == torch.int32 and codes.shape == (N, 2)
    np.testing.assert_array_equal(proj_q.numpy(), np.asarray(want_proj))
    kw = get_config("sah").replace(n_bits=64).kmips_build_kwargs(N)
    del kw["n_bits"]
    prep = sa_alsh.prepare_items(torch.from_numpy(items), **kw)
    live = prep.item_mask.numpy()
    hashed = np.zeros((N, D + 1), np.float32)
    hashed[prep.item_ids.numpy()[live]] = prep.transformed.numpy()[live]
    assert_codes_close(codes.numpy()[:-1], np.asarray(want_codes)[:-1],
                       hashed[:-1], proj)


def test_engine_serving_surface_and_share_dispatch(flow):
    """``server()``/``reverse_server()`` bind the engine's artifact;
    ``share_dispatch`` needs configs equal but for ``scan_budget``."""
    tart = flow["tart"]
    eng = RkMIPSEngine.from_artifact(tart, device="cpu")
    assert eng.server().artifact is tart
    assert eng.reverse_server().engine is eng
    budgeted = RkMIPSEngine(tart.config.replace(scan_budget=2),
                            device="cpu", share_dispatch=eng).attach(tart)
    assert budgeted._sigs is eng._sigs
    with pytest.raises(ValueError, match="equal in every field except "
                                         "scan_budget"):
        RkMIPSEngine(tart.config.replace(n_cand=8), device="cpu",
                     share_dispatch=eng)
    with pytest.raises(TypeError, match="expects an RkMIPSEngine"):
        RkMIPSEngine(tart.config, device="cpu", share_dispatch=object())

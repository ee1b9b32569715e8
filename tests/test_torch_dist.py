"""The port's mesh paths (``repro_torch.dist``, ``launch/mesh.py``, the
sharded build, the sharded reverse and forward queries, and the serving
stack under a mesh) in gloo worlds on the CPU.

Each world is spawned once (2 ranks over "data", make_test_mesh's (2, 2),
3 ranks over "data"; ``tests/torch_mesh_worker.py`` is the rank body, free
of JAX so that the spawned ranks run the port alone). The ranks build from
a seeded corpus under the mesh and attach the artifact the reference saved
over the same corpus. Held:

* bitwise within the port: the mesh build's index equals the single-device
  build's, leaf for leaf; the mesh engine's predictions, plan counters,
  ``truncated`` and funnel equal the single-device engine's in f32 and
  int8, and with a staged delta version; ``tiles_scanned`` and ``chunks``
  (each shard's own packing, summed) and every counter under a scan budget
  (enforced per shard) equal the per-slice composition; the forward scan
  equals its per-slice composition and, at an ``n_cand`` covering a
  shard, the exact top-k; every rank holds the same answer;
* one signature per batch shape; the SPMD call contract, the refusals
  (``query_batch_mapped``; a ``share_dispatch`` donor on another mesh or
  none), and ``make_production_mesh`` on a small world;
* the serving stack: the forward server bitwise the mesh ``kmips`` (at
  every rung, on a staged version), the reverse server bitwise the
  single-device port, runtimes under the controller rank (threads with a
  linger, warmup, a compaction held open while tickets flow and changes
  stage) bitwise the synchronous mesh flush, every rank landing the same
  version, and a three-tenant gateway bitwise the dedicated servers;
* against the reference's sharded semantics, composed from its own
  single-device pieces (its ``shard_map`` fails on jax 0.9.0): integers
  equal, every reverse mismatch traced to a float tie.
"""

import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from repro_torch.core import sah
from repro_torch.dist import NO_SHARDING, ShardingPolicy, lm_rules, shard_rank
from repro_torch.engine import IndexArtifact, RkMIPSEngine, get_config
from repro_torch.engine import sharding
from repro_torch.engine.build import build_sah_index
from repro_torch.kernels import ref as kref

PLAN = ("blocks_alive", "users_alive", "n_no_lb", "n_yes_norm", "n_scan",
        "truncated")
PACKING = ("tiles_scanned", "chunks")
FUNNEL_PACKING = (8, 9)          # PruningFunnel's tiles_scanned, chunks


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's artifact over the worker corpus, with its forward
    index, saved for the ranks to load; and the reference artifact."""
    import jax
    import jax.numpy as jnp
    from repro.engine import IndexArtifact as JaxArtifact
    from repro.engine import get_config as jax_get_config
    items, users = W.corpus()[:2]
    art = JaxArtifact.build(jnp.asarray(items), jnp.asarray(users),
                            jax.random.PRNGKey(W.SEED),
                            config=jax_get_config("sah").replace(**W.BUILD))
    art.ensure_kmips_index()
    path = tmp_path_factory.mktemp("reference_artifact")
    art.save(str(path))
    return str(path), art


@pytest.fixture(scope="module")
def single(reference):
    """The single-device port on the reference's artifact."""
    art = IndexArtifact.load(reference[0], device="cpu")
    _, _, queries, fwd, inserts, deletes = W.corpus()
    q = torch.from_numpy(queries)
    out = {"art": art, "q": q, "fwd": torch.from_numpy(fwd)}
    for name, knob in (("f32", {}), ("int8", dict(scan_precision="int8"))):
        eng = RkMIPSEngine(art.config.replace(**knob), device="cpu")
        out[name] = eng.attach(art).query_batch(q, W.K)
    changed = art.delete_items(deletes).insert_items(inserts)
    eng = RkMIPSEngine.from_artifact(changed, device="cpu")
    out["delta"] = eng.query_batch(q, W.K)
    out["changed"] = changed
    return out


@pytest.fixture(scope="module", params=list(W.WORLDS))
def world(request, reference, tmp_path_factory):
    """(name, shard count, each rank's arrays) of one world, spawned once."""
    path = tmp_path_factory.mktemp(f"world_{request.param}")
    ranks = W.spawn_world(request.param, str(path), reference[0])
    return request.param, len(ranks), ranks


def per_slice(art, q, shards, **knobs):
    """The sharded semantics composed in one process: the padded index cut
    into ``shards`` slices, each answered alone, predictions concatenated
    and counters summed. Returns (predictions in original user space,
    {counter: (nq,) array})."""
    view, d_items, d_mask = art.query_view()
    cfg = art.config.replace(**knobs)
    padded = sharding.pad_index(view, shards)
    parts = [sah.rkmips_batch(
        sharding.shard_slice(padded, shards, s), q, W.K, n_cand=cfg.n_cand,
        scan=cfg.scan, chunk=cfg.chunk, tie_eps=cfg.tie_eps,
        scan_precision=cfg.scan_precision, scan_budget=cfg.scan_budget,
        delta_items=d_items, delta_mask=d_mask) for s in range(shards)]
    pred = torch.cat([p for p, _ in parts], dim=1)
    stats = {f: sum(getattr(st, f) for _, st in parts).numpy()
             for f in W.STATS}
    return sah.predictions_to_original(padded, pred, art.n_users), stats


def assert_same_reverse(got, prefix, want, composed):
    """``got`` (a rank's arrays) against the single-device result ``want``
    bitwise, and against ``composed`` (``per_slice``) for the packing."""
    np.testing.assert_array_equal(got[prefix + "pred"],
                                  want.predictions.numpy())
    for f in PLAN:
        np.testing.assert_array_equal(got[prefix + f],
                                      getattr(want.stats, f).numpy(), f)
    for f in PACKING:
        np.testing.assert_array_equal(got[prefix + f], composed[1][f], f)
    np.testing.assert_array_equal(got[prefix + "pred"],
                                  composed[0].numpy())
    funnel = np.array(tuple(want.funnel))
    keep = [i for i in range(len(funnel)) if i not in FUNNEL_PACKING]
    np.testing.assert_array_equal(got[prefix + "funnel"][keep],
                                  funnel[keep])


# -- the policy and the meshes ----------------------------------------------


@pytest.mark.parametrize("pure_dp", [False, True])
def test_lm_rules_match_the_reference(pure_dp):
    from repro.dist.policy import lm_rules as jax_lm_rules
    for dp in (("data",), ("pod", "data")):
        want = jax_lm_rules(dp, "model", pure_dp=pure_dp)
        got = lm_rules(dp, "model", pure_dp=pure_dp)
        assert got.keys() == want.keys()
        for name, spec in want.items():
            assert got[name] == tuple(spec), (name, got[name], spec)


def test_policy_without_a_mesh_is_the_identity():
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    p = ShardingPolicy(mesh=None, rules=lm_rules(("data",), "model"))
    x = torch.ones(2)
    assert p.sharding("act_btd") is None and p.constrain(x, "act_btd") is x
    assert p.spec("act_btd") == ("data", "model", None)
    for pol in (p, NO_SHARDING):
        assert (pol.dp_axes(), pol.dp_size, pol.model_axis_size,
                pol.device_count, shard_rank(pol)) == ((), 1, 1, 1, 0)
    # importing launch/mesh.py initialized no process group; a mesh needs one
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh_lib.make_production_mesh()
    with pytest.raises(RuntimeError, match="4 ranks"):
        mesh_lib.make_test_mesh(device_type="cpu")


# -- row-count invariance in one process (the shards= seam) -----------------


@pytest.mark.parametrize("shards", [3, 8])
@pytest.mark.parametrize("n,m", [(97, 7), (130, 64), (259, 101)])
def test_sharded_build_is_bitwise_at_any_row_count(n, m, shards):
    """The reference's ``test_build`` cases: a build whose row-parallel
    stages run as ``shards`` slices equals the single-device build, leaf
    for leaf. The reference fails (97, 7) at 8 shards (its lower-bound
    GEMM rounds a 1-row slice differently); the port takes the bounds,
    tau and every product that feeds a decision by fixed-shape row chunks
    (``core/rows.py``), so it passes every case."""
    import jax
    ki, ku = jax.random.split(jax.random.PRNGKey(11))
    items = np.array(jax.random.normal(ki, (n, 16))
                       * np.linspace(0.5, 2.0, n)[:, None], np.float32)
    users = np.array(jax.random.normal(ku, (m, 16)), np.float32)
    cfg = get_config("sah").replace(k_max=3, tile=32, leaf_size=4,
                                    n_bits=64)
    items, users = torch.from_numpy(items), torch.from_numpy(users)

    def build(**kw):
        return build_sah_index(items, users, torch.Generator().manual_seed(5),
                               config=cfg, **kw)

    single, t0 = build()
    split, t1 = build(shards=shards)
    assert not t0.sharded and t1.sharded and "sharded" in t1.format()
    want = W.index_arrays(single, "")
    for name, got in W.index_arrays(split, "").items():
        np.testing.assert_array_equal(got, want[name], name)


# -- the gloo worlds ----------------------------------------------------------


def test_mesh_build_is_bitwise(world):
    _, _, ranks = world
    items, users = W.corpus()[:2]
    want = IndexArtifact.build(items, users,
                               torch.Generator().manual_seed(W.SEED),
                               config=get_config("sah").replace(**W.BUILD),
                               device="cpu")
    want = W.index_arrays(want.index, "build/")
    for got in ranks:
        assert bool(got["build/sharded"])
        for name, arr in want.items():
            np.testing.assert_array_equal(got[name], arr, name)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_mesh_reverse_is_bitwise(world, single, precision):
    _, shards, ranks = world
    composed = per_slice(single["art"], single["q"], shards,
                         scan_precision=precision)
    assert single[precision].stats.n_scan.sum() > 0     # the scan ran
    for got in ranks:
        assert_same_reverse(got, precision + "/", single["f32"], composed)
        np.testing.assert_array_equal(got["query/pred"],
                                      got["f32/pred"][0])


def test_mesh_reverse_with_a_delta_version_is_bitwise(world, single):
    _, shards, ranks = world
    composed = per_slice(single["changed"], single["q"], shards)
    for got in ranks:
        for prefix in ("delta/", "delta8/"):
            assert_same_reverse(got, prefix, single["delta"], composed)


def test_mesh_scan_budget_is_per_shard(world, single):
    _, shards, ranks = world
    pred, stats = per_slice(single["art"], single["q"], shards,
                            scan_budget=W.BUDGET)
    assert stats["truncated"].sum() > 0                 # the budget bit
    for got in ranks:
        np.testing.assert_array_equal(got["budget/pred"], pred.numpy())
        for f in W.STATS:
            np.testing.assert_array_equal(got["budget/" + f], stats[f], f)


def test_mesh_forward_equals_its_composition(world, single):
    _, shards, ranks = world
    idx = single["art"].ensure_kmips_index()
    fwd = single["fwd"]
    rows = sharding.pad_item_rows(idx.items, idx.item_ids, idx.item_mask,
                                  idx.codes, shards, W.K)
    per = rows[0].shape[0] // shards
    ucodes = kref.srp_hash(fwd, idx.proj[:-1])
    parts = [sharding.kmips_flat_arrays(*(r[s * per:(s + 1) * per]
                                          for r in rows), ucodes, fwd, W.K,
                                        n_cand=W.N)
             for s in range(shards)]
    vals = torch.cat([v for v, _ in parts], dim=1)
    best, pos = kref.topk_stable(vals, W.K)
    ids = torch.cat([i for _, i in parts], dim=1).gather(1, pos)
    exact_vals, exact_ids = kref.ip_topk(fwd, torch.from_numpy(
        W.corpus()[0]), W.K)
    for got in ranks:
        np.testing.assert_array_equal(got["fwd/vals"], best.numpy())
        np.testing.assert_array_equal(got["fwd/ids"], ids.numpy())
        assert int(got["fwd/tiles"]) == idx.tile_max_norm.shape[0]
        # n_cand covers a shard: the exact top-k, but for float ties
        moved = got["fwd/ids"] != exact_ids.numpy()
        np.testing.assert_allclose(got["fwd/vals"], exact_vals.numpy(),
                                   rtol=1e-6, atol=1e-6)
        assert moved.sum() <= 2, moved.sum()


def test_mesh_signatures_contract_and_refusals(world):
    _, shards, ranks = world
    for r, got in enumerate(ranks):
        assert int(got["shard_rank"]) == r
        # warmup's 2 cells (no buffer, the empty buffer), then one
        # signature a batch shape
        assert got["signatures"].tolist() == [2, 2, 2, 3]
        assert "different queries" in str(got["spmd_error"])
        for refusal in ("share_other_mesh", "share_no_mesh"):
            assert "same sharding policy mesh" in str(got[refusal])
        assert bool(got["share_same_mesh"])
        assert "single-device" in str(got["mapped_error"])
        assert f"has {shards}" in str(got["production_error"])
        assert "256 ranks" in str(got["production_error"])
    m_local = {int(g["m_local"]) for g in ranks}
    assert len(m_local) == 1
    # every rank holds the same answers (rank 0 alone holds the
    # controller's comparisons, the followers their refusal)
    for got in ranks[1:]:
        for name, arr in ranks[0].items():
            if name in ("shard_rank", "production_error") + W.LEAD_ONLY:
                continue
            np.testing.assert_array_equal(got[name], arr, name)


# -- the serving stack under the mesh ----------------------------------------


def test_mesh_forward_server_is_bitwise(world):
    """The forward server under the mesh: bitwise the mesh engine's
    ``kmips`` at the config's ``n_cand``, at ``n_cand`` covering a shard
    the exact top-k (but for float ties) and bitwise the engine's exact
    scan, every rung bitwise the full batch, no rebuild of the artifact's
    forward index, and a server over a staged version (row 0 deleted,
    rows inserted) bitwise ``kmips`` on that version."""
    _, _, ranks = world
    items, _, _, fwd, _, _ = W.corpus()
    exact_vals, exact_ids = kref.ip_topk(torch.from_numpy(fwd),
                                         torch.from_numpy(items), W.K)
    for got in ranks:
        for prefix in ("srv/", "srv_staged/"):
            np.testing.assert_array_equal(got[prefix + "ids"],
                                          got[prefix + "kmips_ids"])
            np.testing.assert_array_equal(got[prefix + "vals"],
                                          got[prefix + "kmips_vals"])
        np.testing.assert_array_equal(got["srv_exact/ids"], got["fwd/ids"])
        np.testing.assert_array_equal(got["srv_exact/vals"],
                                      got["fwd/vals"])
        np.testing.assert_allclose(got["srv_exact/vals"],
                                   exact_vals.numpy(), rtol=1e-6, atol=1e-6)
        assert (got["srv_exact/ids"] != exact_ids.numpy()).sum() <= 2
        assert bool(got["srv/rungs"]) and int(got["srv/builds"]) == 0
        assert 0 not in got["srv_staged/ids"]          # the deleted row 0
        assert not np.array_equal(got["srv_staged/ids"], got["srv/ids"])


def test_mesh_forward_server_matches_the_reference_composition(world,
                                                               reference):
    """The reference's mesh serving state composed from its own pieces:
    ``state_from_index`` of its forward index, padded by ``pad_item_rows``,
    each slice answered by ``kmips_flat_arrays`` without a mesh at the
    config's ``n_cand``, the winners merged by ``lax.top_k``."""
    import jax
    import jax.numpy as jnp
    from repro.core import sa_alsh as jalsh
    from repro.dist.policy import NO_SHARDING as JAX_NO_SHARDING
    from repro.engine import serving as jserving
    from repro.engine import sharding as jsharding
    _, shards, ranks = world
    art = reference[1]
    state = jserving.state_from_index(art.ensure_kmips_index(), art.config)
    rows = jsharding.pad_item_rows(state.items, state.item_ids,
                                   state.item_mask, state.codes, shards)
    per = rows[0].shape[0] // shards
    fwd = jnp.asarray(W.corpus()[3])
    ucodes = jalsh.user_codes(art.ensure_kmips_index(), fwd)
    parts = [jsharding.kmips_flat_arrays(
        *(r[s * per:(s + 1) * per] for r in rows), ucodes, fwd, W.K,
        JAX_NO_SHARDING, n_cand=art.config.n_cand) for s in range(shards)]
    best, pos = jax.lax.top_k(
        jnp.concatenate([v for v, _ in parts], axis=1), W.K)
    ids = np.asarray(jnp.take_along_axis(
        jnp.concatenate([i for _, i in parts], axis=1), pos, axis=1))
    best = np.asarray(best)
    for got in ranks:
        np.testing.assert_allclose(got["srv/vals"], best, rtol=1e-5)
        moved = got["srv/ids"] != ids
        # an id may move only between inner products within rounding
        assert np.all(np.abs(got["srv/vals"][moved] - best[moved])
                      <= 1e-5), moved.sum()
        assert moved.sum() <= 2, moved.sum()


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_mesh_reverse_server_is_bitwise(world, single, precision):
    """The reverse server under the mesh, its 4 tickets one dispatch:
    predictions and plan counters bitwise the single-device port, packing
    the per-slice composition."""
    _, shards, ranks = world
    composed = per_slice(single["art"], single["q"], shards,
                         scan_precision=precision)
    for got in ranks:
        assert_same_reverse(got, f"rsrv_{precision}/", single["f32"],
                            composed)


def test_mesh_runtimes_under_the_controller(world):
    """Two runtimes on one stream, tickets submitted on the controller
    from two threads with a linger, warmed: every ticket bitwise the
    synchronous mesh flush, no signature after warmup on any rank, the
    followers' counters the controller's; a bad k fails its ticket and is
    counted failed on every rank; ``submit`` on a follower raises;
    ``close`` ends every rank's stream thread, after the same operations
    on every rank."""
    _, _, ranks = world
    lead = ranks[0]
    assert bool(lead["rt/reverse_same"]) and bool(lead["rt/forward_same"])
    assert "outside [1," in str(lead["rt/bad_k_error"])
    for r, got in enumerate(ranks):
        assert got["rt/drained"].tolist() == [True, True]
        assert got["rt/server_types"].tolist() == ["ReverseServer",
                                                  "RetrievalServer"]
        # (completed, failed, traces after warmup) of each runtime
        assert got["rt/stats"].tolist() == [[4, 0, 0], [6, 1, 0]]
        if r:
            assert "controller rank 0 admits" in str(got["rt/submit_error"])
        np.testing.assert_array_equal(got["stream/ops"], lead["stream/ops"])
    ops = dict(zip(("dispatch", "insert", "delete", "swap", "compact_start",
                    "compact_land"), lead["stream/ops"].tolist()))
    # the gated runtime's inserts, its delete and one that raised on
    # every rank; the gateway's swap
    assert ops["insert"] == 2 and ops["delete"] == 2 and ops["swap"] == 1
    assert ops["compact_start"] == ops["compact_land"] == 1


def test_mesh_compaction_interleaves_with_dispatches(world, single):
    """An insert, a delete and a compaction held open by a gate on the
    controller while tickets flow and more rows stage: the compaction
    lands on every rank (row-parallel on the runtime's own group), every
    rank's live version has the same fingerprint and index, equal to the
    single-device port's reconcile of the same changes, and the answers
    after the landing are a synchronous server's on it."""
    from repro_torch.engine import reconcile_compaction
    _, _, ranks = world
    _, _, _, _, inserts, deletes = W.corpus()
    sart = single["art"].with_config(
        single["art"].config.replace(**W.SERVE))
    snap = sart.insert_items(inserts).delete_items(deletes)
    merged = reconcile_compaction(
        snap, snap.insert_items((0.9 * inserts[:2]).astype(np.float32)),
        snap.compact())
    want = W.index_arrays(merged.index, "gated/")
    assert bool(ranks[0]["gated/held"]) and bool(ranks[0]["gated/after_same"])
    for got in ranks:
        assert "item ids must be in" in str(got["gated/bad_delete"])
        assert str(got["gated/fingerprint"]) == merged.fingerprint
        assert bool(got["gated/sharded"]) and bool(got["gated/drained"])
        assert got["gated/pending"].tolist() == [merged.n_base,
                                                 merged.delta_used]
        # 1 compaction; 4 versions: insert, delete, insert, the landing
        assert got["gated/counts"].tolist() == [1, 4, 8]
        for name, arr in want.items():
            np.testing.assert_array_equal(got[name], arr, name)


def test_mesh_gateway_is_bitwise(world):
    """Three tenants on one pool under the mesh (two reverse, one with a
    scan budget, and one forward): answers bitwise the dedicated
    synchronous mesh servers, the reverse tenants on one signature set,
    none added after warmup, a swap served on every rank."""
    _, _, ranks = world
    assert ranks[0]["gw/same"].tolist() == [True, True, True]
    assert bool(ranks[0]["gw/swapped_same"])
    for got in ranks:
        assert bool(got["gw/shared"]) and bool(got["gw/drained"])
        # traces after warmup, then each tenant's completed tickets
        assert got["gw/stats"].tolist() == [0, 4, 4, 12]


# -- against the reference's sharded semantics --------------------------------


def test_mesh_reverse_matches_the_reference_composition(world, reference):
    """The reference's sharded reverse query composed from its own pieces:
    ``pad_index``, ``core.sah.rkmips_batch`` on each user slice, the
    predictions concatenated and the counters summed."""
    import jax.numpy as jnp
    from repro.core import sah as jsah
    from repro.engine import sharding as jsharding
    from test_torch_sah import assert_traced, reference_index_arrays
    _, shards, ranks = world
    art = reference[1]
    view = art.index
    queries = W.corpus()[2]
    padded = jsharding.pad_index(view, shards)
    b = padded.n_blocks // shards
    u = b * (padded.n_users // padded.n_blocks)
    preds, stats = [], []
    for s in range(shards):
        part = padded._replace(
            **{f: getattr(padded, f)[s * u:(s + 1) * u]
               for f in sharding._USER_AXIS_FIELDS},
            **{f: getattr(padded, f)[s * b:(s + 1) * b]
               for f in sharding._BLOCK_AXIS_FIELDS})
        p, st = jsah.rkmips_batch(part, jnp.asarray(queries), W.K,
                                  **art.config.query_kwargs())
        preds.append(np.asarray(p))
        stats.append(st)
    want = np.asarray(jsah.predictions_to_original(
        padded, jnp.asarray(np.concatenate(preds, axis=1)), art.n_users))
    got = ranks[0]["f32/pred"]
    arrays = reference_index_arrays(view)
    index = sah.index_from_numpy(arrays, "cpu")
    ids, mask = arrays["index/user_ids"], arrays["index/user_mask"]
    n_tied = assert_traced(arrays, index, queries, W.K,
                           want[:, ids] & mask, got[:, ids] & mask)
    assert n_tied <= 0.001 * want.size, n_tied
    for f in PLAN:
        ref = sum(np.asarray(getattr(st, f)) for st in stats)
        assert np.all(np.abs(ranks[0]["f32/" + f] - ref) <= n_tied), f


def test_mesh_forward_matches_the_reference_composition(world, reference):
    """The reference's sharded forward scan composed from its own pieces:
    ``pad_item_rows``, ``kmips_flat_arrays(..., NO_SHARDING)`` on each
    slice, then ``lax.top_k`` on the concatenation."""
    import jax
    import jax.numpy as jnp
    from repro.core import sa_alsh as jalsh
    from repro.dist.policy import NO_SHARDING as JAX_NO_SHARDING
    from repro.engine import sharding as jsharding
    _, shards, ranks = world
    idx = reference[1].ensure_kmips_index()
    fwd = jnp.asarray(W.corpus()[3])
    rows = jsharding.pad_item_rows(idx.items, idx.item_ids, idx.item_mask,
                                   idx.codes, shards, W.K)
    per = rows[0].shape[0] // shards
    ucodes = jalsh.user_codes(idx, fwd)
    parts = [jsharding.kmips_flat_arrays(
        *(r[s * per:(s + 1) * per] for r in rows), ucodes, fwd, W.K,
        JAX_NO_SHARDING, n_cand=W.N) for s in range(shards)]
    vals = jnp.concatenate([v for v, _ in parts], axis=1)
    best, pos = jax.lax.top_k(vals, W.K)
    ids = np.asarray(jnp.take_along_axis(
        jnp.concatenate([i for _, i in parts], axis=1), pos, axis=1))
    got = ranks[0]
    np.testing.assert_allclose(got["fwd/vals"], np.asarray(best),
                               rtol=1e-6, atol=1e-6)
    moved = got["fwd/ids"] != ids
    # an id may move only between inner products within float rounding
    assert np.all(np.abs(got["fwd/vals"][moved]
                         - np.asarray(best)[moved]) <= 1e-5), moved.sum()
    assert moved.sum() <= 2, moved.sum()


# -- on the card ----------------------------------------------------------------


@pytest.mark.gpu
def test_kernels_in_a_gloo_world_on_one_card(tmp_path):
    """Two ranks share cuda:0 over gloo: ``row_parallel`` hashes each
    rank's slice with the CUDA ``srp_hash`` (one launch a rank) and each
    rank scores its slice with the dense ``hamming_scores`` (one launch),
    both equal to their plain versions, and the gathered slices to the
    whole."""
    import torch.multiprocessing as mp
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mp.spawn(W.kernel_rank_main, args=(2, str(tmp_path)), nprocs=2,
             join=True)
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        assert got["launches"].tolist() == [1, 1]
        assert bool(got["codes"]) and bool(got["dist_slice"])
        assert bool(got["dist_all"])

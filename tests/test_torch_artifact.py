"""The index artifact of the port (``repro_torch.engine.artifact``, with
``engine/build.py``, ``train/checkpoint.py`` and ``core/transforms.py``)
held against the JAX reference on the CPU.

The reference's random draws are injected into the port's build (as in
``test_torch_engine.py``) and its key is handed over, so both packages
hold the same content. Then:

* a reference-saved artifact loads in the port and a port-saved one in
  the reference, each passing the loader's fingerprint re-check, with
  fingerprints equal across the packages; corrupted bytes fail both
  loaders;
* after ``insert_items`` / ``delete_items`` (base rows of P' and of the
  rest, and staged rows), the predictions and the plan counters equal the
  reference's on the same artifact, and so do the forward top-k ids, but
  where a difference traces to a float tie (``test_torch_sah.trace``,
  ``test_torch_kmips.traced_differences``);
* ``compact`` equals the reference's compact: the same fingerprint,
  integer arrays equal, floats allclose, codes but for flips within float
  rounding of 0; ``reconcile_compaction`` and the bookkeeping errors
  equal the reference's;
* inside the port, bitwise: int8 equals f32 with staged rows on the
  reverse and forward paths, batched equals per-query with a delta
  buffer, a ``merge_delta_topk`` batch row equals the query alone, and
  under ``scan="exact"`` the pre-compact answers equal a from-scratch
  build's on the effective corpus.

The card's side (``hamming_nearest`` and ``fused_scan`` on a tile whose
deleted rows are masked inside it) is a ``gpu`` test in
``test_torch_kernels.py``, which runs where JAX is absent.
"""

import os
import re
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import srp as jsrp
from repro.core import transforms as jtransforms
from repro.engine import config as jconfig
from repro.engine.artifact import KMIPS_KEY_TAG
from repro.engine.artifact import IndexArtifact as JaxArtifact
from repro.engine.artifact import reconcile_compaction as jax_reconcile
from repro.engine.engine import RkMIPSEngine as JaxEngine
from repro.train import checkpoint as jckpt
from repro_torch.core import sa_alsh, sah, transforms
from repro_torch.engine import (BuildTimings, IndexArtifact, RkMIPSEngine,
                                build_sah_index, get_config, load_artifact,
                                reconcile_compaction)
from repro_torch.engine.artifact import _flatten_named
from repro_torch.train import checkpoint
from test_torch_core import (assert_codes_close, assert_field, mf_data,
                             reference_draws)
from test_torch_kmips import traced_differences
from test_torch_sah import trace

N, M, D = 1000, 2000, 16
CFG = dict(k_max=50, tile=256, delta_capacity=32)
KEY = jax.random.PRNGKey(0)
N_TOP = 100                     # 2 * k_max


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's host loops issue many tiny ops: one intra-op thread per
    test process keeps a many-worker run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mutate(art, dels, rows, staged_dels):
    """The catalogue change, the same calls in both packages."""
    return art.delete_items(dels).insert_items(rows).delete_items(
        staged_dels)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """One corpus, its catalogue change, and both packages' artifacts
    before and after it (the port's loaded from the reference's save)."""
    items, users = mf_data(10, N, M, D)
    order = np.argsort(-np.linalg.norm(items, axis=1), kind="stable")
    rng = np.random.default_rng(2)
    queries = items[order[rng.choice(int(0.03 * N), 4, replace=False)]]
    top = int(0.2 * N)
    # 3 members of P' (the bounds are recomputed) and 12 more of the top
    # 20% by norm; 20 noisy copies of top-20% items; 2 staged rows again
    dels = np.concatenate([order[rng.choice(N_TOP, 3, replace=False)],
                           order[N_TOP + rng.choice(top - N_TOP, 12,
                                                    replace=False)]])
    src = items[order[rng.choice(top, 20)]]
    noise = rng.standard_normal(src.shape) * (
        0.05 * np.linalg.norm(src, axis=1, keepdims=True) / np.sqrt(D))
    rows = (src + noise).astype(np.float32)
    staged_dels = [N + 3, N + 7]

    root = tmp_path_factory.mktemp("artifacts")
    jcfg = jconfig.get_config("sah").replace(**CFG)
    jart = JaxArtifact.build(jnp.asarray(items), jnp.asarray(users), KEY,
                             config=jcfg)
    jart.save(str(root / "bare"))          # no forward index yet
    jart.ensure_kmips_index()
    jart.save(str(root / "full"))
    jart2 = mutate(jart, dels, jnp.asarray(rows), staged_dels)
    tart = IndexArtifact.load(str(root / "full"), device="cpu")
    tart2 = mutate(tart, dels, rows, staged_dels)
    kproj = np.array(jsrp.make_projection(
        jax.random.fold_in(KEY, KMIPS_KEY_TAG), D + 1, 128))
    return types.SimpleNamespace(
        items=items, users=users, queries=queries, dels=dels, rows=rows,
        staged_dels=staged_dels, root=root, jart=jart, jart2=jart2,
        tart=tart, tart2=tart2, kproj=kproj, memo={})


def engines(flow, precision="f32"):
    """(reference engine, port engine) on the mutated artifact."""
    key = ("engines", precision)
    if key not in flow.memo:
        tcfg = flow.tart2.config.replace(scan_precision=precision)
        flow.memo[key] = (JaxEngine.from_artifact(flow.jart2),
                          RkMIPSEngine(tcfg, device="cpu").attach(
                              flow.tart2))
    return flow.memo[key]


def answers(flow, k, precision="f32"):
    """The port's and the reference's query_batch on the mutated
    artifact, computed once."""
    key = ("answers", k, precision)
    if key not in flow.memo:
        jeng, teng = engines(flow, precision)
        want = jeng.query_batch(jnp.asarray(flow.queries), k) \
            if precision == "f32" else None
        flow.memo[key] = (want, teng.query_batch(flow.queries, k))
    return flow.memo[key]


def trace_arrays(art):
    """The port's query view as numpy arrays under the artifact names,
    with P' replaced by the effective corpus's rows outside the rest:
    the live members of P' and the live staged rows (what the tracer
    counts an item's inner product over)."""
    view, d_items, d_mask = art.query_view()
    arrays = {}
    _flatten_named("index/", view, arrays)
    live_top = ~art.deleted[view.top_ids.long()].numpy()
    extra = [arrays["index/top_items"][live_top]]
    if d_items is not None:
        extra.append(d_items[d_mask].numpy())
    arrays["index/top_items"] = np.concatenate(extra)
    return view, arrays


def assert_predictions_traced(arrays, view, queries, k, want, got):
    real = arrays["index/user_mask"]
    lane_of = {int(u): j for j, u in reversed(list(enumerate(
        arrays["index/user_ids"]))) if real[j]}
    diff = np.argwhere(np.asarray(want) != got.numpy())
    for qi, u in diff:
        trace(arrays, view, queries[qi], k, [lane_of[int(u)]])
    assert len(diff) <= 0.001 * got.numel()


# -- save and load, both ways -------------------------------------------------


def test_reference_artifact_loads_in_the_port(flow):
    tart, jart = flow.tart, flow.jart
    assert tart.fingerprint == jart.fingerprint
    assert tart.manifest == {**jart.manifest, "has_kmips": True}
    assert tart.key.dtype == np.uint32 and np.array_equal(
        tart.key, np.asarray(KEY))
    assert torch.equal(tart.kmips_proj, torch.from_numpy(flow.kproj))
    want = jart.index.alsh.codes
    assert np.array_equal(tart.index.alsh.codes.numpy().view(np.uint32),
                          np.asarray(want))
    with pytest.raises(ValueError, match="pass kmips_proj"):
        IndexArtifact.load(str(flow.root / "bare"), device="cpu")
    bare = load_artifact(str(flow.root / "bare"), device="cpu",
                         kmips_proj=flow.kproj)
    assert bare.fingerprint == jart.fingerprint
    assert bare.kmips_index is None
    assert torch.equal(bare.ensure_kmips_index().item_ids,
                       tart.kmips_index.item_ids)
    jeng = JaxEngine.from_artifact(jart)
    teng = RkMIPSEngine.from_artifact(tart, device="cpu")
    want = jeng.query_batch(jnp.asarray(flow.queries), 10)
    got = teng.query_batch(flow.queries, 10)
    view, arrays = trace_arrays(tart)
    assert_predictions_traced(arrays, view, flow.queries, 10,
                              want.predictions, got.predictions)
    assert got.funnel.scan_lanes == want.funnel.scan_lanes
    assert teng.build_timings is None


def test_port_artifact_loads_in_the_reference(flow):
    proj, perm = reference_draws(KEY, D, 128, M, 32)
    built = IndexArtifact.build(
        flow.items, flow.users, config=get_config("sah").replace(**CFG),
        key=np.asarray(KEY), proj=proj, cone_order=perm,
        kmips_proj=flow.kproj, device="cpu")
    assert isinstance(built.build_timings, BuildTimings)
    assert built.fingerprint == flow.jart.fingerprint
    mutated = mutate(built, flow.dels, flow.rows, flow.staged_dels)
    assert mutated.fingerprint == flow.jart2.fingerprint
    path = str(flow.root / "port")
    mutated.save(path)
    loaded = JaxArtifact.load(path)
    assert loaded.fingerprint == flow.jart2.fingerprint
    assert loaded.kmips_index is not None
    assert np.asarray(loaded.index.alsh.codes).dtype == np.uint32
    # the reference answers on the port's arrays as the port does
    want = JaxEngine.from_artifact(loaded).query_batch(
        jnp.asarray(flow.queries), 10)
    got = RkMIPSEngine.from_artifact(mutated, device="cpu").query_batch(
        flow.queries, 10)
    view, arrays = trace_arrays(mutated)
    assert_predictions_traced(arrays, view, flow.queries, 10,
                              want.predictions, got.predictions)
    again = IndexArtifact.load(path, device="cpu")
    assert again.fingerprint == mutated.fingerprint
    assert again.delta_used == mutated.delta_used == 20
    # the buffer's int8 twin is written in the reference's layout
    manifest = checkpoint.read_manifest(path, 0)
    like = {name: np.empty(v["shape"], np.dtype(v["dtype"]))
            for name, v in manifest["index"].items()}
    tree, _ = checkpoint.restore(path, 0, like)
    np.testing.assert_array_equal(tree["delta_qitems"],
                                  np.asarray(flow.jart2.delta_qitems))
    np.testing.assert_array_equal(tree["delta_qscale"],
                                  np.asarray(flow.jart2.delta_qscale))


def test_corrupted_bytes_fail_both_loaders(flow, tmp_path):
    src = flow.root / "full"
    bad = tmp_path / "bad"
    shutil.copytree(src, bad)
    step = bad / "step_00000000"
    manifest = checkpoint.read_manifest(str(bad), 0)
    leaf = manifest["index"]["items"]["file"]
    with np.load(step / "arrays_00000.npz") as data:
        arrays = {name: data[name] for name in data.files}
    arrays[leaf] = arrays[leaf].copy()
    arrays[leaf][7, 3] += 1e-3
    np.savez(step / "arrays_00000.npz", **arrays)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        IndexArtifact.load(str(bad), device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        JaxArtifact.load(str(bad))


# -- staged deltas ------------------------------------------------------------


@pytest.mark.parametrize("k", [10, 50])
def test_predictions_with_deltas_match_reference(flow, k):
    want, got = answers(flow, k)
    view, arrays = trace_arrays(flow.tart2)
    assert_predictions_traced(arrays, view, flow.queries, k,
                              want.predictions, got.predictions)
    for f in ("queries", "blocks_total", "blocks_alive", "users_total",
              "users_alive", "decided_no_lb", "decided_yes_norm",
              "scan_lanes", "truncated"):
        assert getattr(got.funnel, f) == getattr(want.funnel, f), f
    # the change moved the answers
    base = RkMIPSEngine.from_artifact(flow.tart, device="cpu").query_batch(
        flow.queries, k)
    assert not torch.equal(base.predictions, got.predictions)


def test_delta_view_matches_reference(flow):
    got, d_items, d_mask = flow.tart2.query_view()
    want, j_items, j_mask = flow.jart2.query_view()
    for f in ("user_lb", "block_lb", "top_norms"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    assert bool(torch.isinf(got.user_lb).any()) is False
    np.testing.assert_array_equal(got.alsh.item_mask.numpy(),
                                  np.asarray(want.alsh.item_mask))
    np.testing.assert_array_equal(d_mask.numpy(), np.asarray(j_mask))
    np.testing.assert_array_equal(d_items.numpy(), np.asarray(j_items))
    np.testing.assert_array_equal(flow.tart2.effective_ids(),
                                  flow.jart2.effective_ids())
    assert torch.equal(flow.tart2.effective_items(), torch.from_numpy(
        np.array(flow.jart2.effective_items())))
    assert flow.tart2.n_items == flow.jart2.n_items == N - 15 + 18
    # a delete-only version passes no buffer
    del_only = flow.tart.delete_items(flow.dels)
    assert del_only.query_view()[1:] == (None, None)
    assert del_only.kmips_delta() == (None, None)


def test_forward_kmips_with_deltas_matches_reference(flow):
    jeng, teng = engines(flow)
    # 56 users, and 8 staged rows as queries (their own rows rank high)
    users = np.concatenate([flow.users[:56], flow.rows[:8]])
    want = jeng.kmips(jnp.asarray(users), 50)
    got = teng.kmips(users, 50)
    every = np.concatenate([flow.items, flow.tart2.delta_items.numpy()])
    n = traced_differences(every, users, flow.kproj, got.ids.numpy(),
                           np.asarray(want.ids))
    assert n <= 0.01 * got.ids.numel()
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-5, atol=1e-6)
    assert bool((got.ids >= N).any())              # staged rows answer
    assert not np.isin(got.ids.numpy(), flow.dels).any()
    assert not np.isin(got.ids.numpy(), flow.staged_dels).any()


@pytest.mark.parametrize("k", [10, 50])
def test_int8_equals_f32_with_staged_rows(flow, k):
    _, f32 = answers(flow, k)
    _, int8 = answers(flow, k, "int8")
    assert torch.equal(int8.predictions, f32.predictions)
    for a, b in zip(int8.stats, f32.stats):
        assert torch.equal(a, b)
    if k == 10:
        users = flow.users[:64]
        a = engines(flow)[1].kmips(users, 10)
        b = engines(flow, "int8")[1].kmips(users, 10)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.values, b.values)


def test_batched_equals_per_query_with_a_delta_buffer(flow):
    view, d_items, d_mask = flow.tart2.query_view()
    delta = dict(delta_items=d_items, delta_mask=d_mask)
    q = torch.from_numpy(flow.queries)
    for precision in ("f32", "int8"):
        pred, stats = sah.rkmips_batch(view, q, 10, tie_eps=1e-5,
                                       scan_precision=precision, **delta)
        for i in range(len(q)):
            one, st = sah.rkmips(view, q[i], 10, tie_eps=1e-5,
                                 scan_precision=precision, **delta)
            assert torch.equal(one, pred[i])
            for f in ("blocks_alive", "users_alive", "n_no_lb",
                      "n_yes_norm", "n_scan"):
                assert getattr(st, f) == int(getattr(stats, f)[i]), f


def test_merge_delta_topk_batch_row_equals_the_query_alone():
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((9, 24)).astype(np.float32))
    d_items = torch.from_numpy(rng.standard_normal((40, 24)).astype(
        np.float32))
    d_mask = torch.from_numpy(rng.random(40) < 0.7)
    d_items[~d_mask] = 0.0
    vals = torch.sort(torch.from_numpy(rng.standard_normal((9, 5)).astype(
        np.float32) * 3), dim=-1, descending=True).values
    ids = torch.from_numpy(rng.integers(0, 100, (9, 5)).astype(np.int32))
    out = sa_alsh.merge_delta_topk(vals, ids, q, d_items, d_mask, 5, 100)
    for i in (0, 4, 8):
        v, j = sa_alsh.merge_delta_topk(vals[i:i + 1], ids[i:i + 1],
                                        q[i:i + 1], d_items, d_mask, 5, 100)
        assert torch.equal(v[0], out[0][i])
        assert torch.equal(j[0], out[1][i])
    assert bool((out[1] >= 100).any())
    dead = torch.nonzero(~d_mask).squeeze(1) + 100
    assert not bool(torch.isin(out[1], dead).any())


def test_the_references_int8_delta_screen_answers_as_the_port(flow):
    """The reference screens staged rows with their int8 twin; the port
    counts and merges them in f32 under every precision. The reference's
    int8 answers on the mutated artifact are the port's."""
    jcfg = flow.jart2.config.replace(scan_precision="int8")
    jeng = JaxEngine(jcfg).attach(flow.jart2)
    want = jeng.query_batch(jnp.asarray(flow.queries), 10)
    _, got = answers(flow, 10, "int8")
    view, arrays = trace_arrays(flow.tart2)
    assert_predictions_traced(arrays, view, flow.queries, 10,
                              want.predictions, got.predictions)
    assert got.funnel.scan_lanes == want.funnel.scan_lanes
    users = np.concatenate([flow.users[:24], flow.rows[:8]])
    jk = jeng.kmips(jnp.asarray(users), 10)
    tk = engines(flow, "int8")[1].kmips(users, 10)
    every = np.concatenate([flow.items, flow.tart2.delta_items.numpy()])
    n = traced_differences(every, users, flow.kproj, tk.ids.numpy(),
                           np.asarray(jk.ids))
    assert n <= 0.01 * tk.ids.numel()
    np.testing.assert_allclose(tk.values.numpy(), np.asarray(jk.values),
                               rtol=1e-5, atol=1e-6)


def test_exact_scan_before_compact_equals_a_fresh_build():
    """Under scan="exact" the delta view answers as a from-scratch build
    on the effective corpus does, bit for bit."""
    items, users = mf_data(11, 700, 900, D)
    cfg = get_config("exact").replace(k_max=20, tile=256,
                                      delta_capacity=16)
    state = torch.Generator().manual_seed(5).get_state()
    art = IndexArtifact.build(items, users,
                              torch.Generator().set_state(state),
                              config=cfg, device="cpu")
    order = np.argsort(-np.linalg.norm(items, axis=1), kind="stable")
    rng = np.random.default_rng(6)
    rows = (items[order[:12]] * (1 + 0.02 * rng.standard_normal(
        (12, D)))).astype(np.float32)
    changed = mutate(art, np.concatenate([order[[0, 3, 39]], order[60:70]]),
                     rows, [700 + 2])
    fresh = RkMIPSEngine(cfg, device="cpu").build(
        changed.effective_items(), users, torch.Generator().set_state(state))
    mine = RkMIPSEngine.from_artifact(changed, device="cpu")
    q = items[order[rng.choice(40, 5, replace=False)]]
    for k in (5, 20):
        got = mine.query_batch(q, k).predictions
        assert torch.equal(got, fresh.query_batch(q, k).predictions)
    assert fresh.artifact.fingerprint == changed.compact().fingerprint


# -- compact ------------------------------------------------------------------


def compacted(flow):
    """(reference, port) compaction of the mutated artifact, made once."""
    if "compact" not in flow.memo:
        flow.memo["compact"] = (flow.jart2.compact(), flow.tart2.compact())
    return flow.memo["compact"]


def test_compact_matches_reference(flow):
    jcomp, tcomp = compacted(flow)
    assert tcomp.fingerprint == jcomp.fingerprint
    assert not tcomp.has_pending and tcomp.n_base == flow.tart2.n_items
    assert tcomp.delta_capacity == 32 and tcomp.kmips_index is None
    assert torch.equal(tcomp.kmips_proj, flow.tart2.kmips_proj)
    assert isinstance(tcomp.build_timings, BuildTimings)
    assert "single-device" in tcomp.build_timings.format()
    got, want = tcomp.index, jcomp.index
    for f in sah.SAHIndex._fields:
        if f != "alsh":
            assert_field(f, getattr(got, f), getattr(want, f))
    for f in sa_alsh.SAALSHIndex._fields:
        if f != "codes":
            assert_field(f"alsh.{f}", getattr(got.alsh, f),
                         getattr(want.alsh, f))
    rest = tcomp.effective_items()[got.alsh.item_ids[
        got.alsh.item_mask].long()]
    rows = sa_alsh.prepare_items(rest, tile=256).transformed.numpy()
    flips = assert_codes_close(got.alsh.codes.numpy()[:len(rest)],
                               np.asarray(want.alsh.codes)[:len(rest)],
                               rows[:len(rest)], np.asarray(want.alsh.proj))
    assert flips <= 4, flips
    assert flow.tart2.compact().fingerprint == tcomp.fingerprint
    assert flow.tart.compact() is flow.tart


def test_reconcile_compaction_matches_reference(flow):
    """Churn after the snapshot: 5 inserts, then a base row, a staged row
    of the snapshot and one of the new rows deleted."""
    extra = flow.rows[:5] * 1.01
    base_id = min(set(range(N)) - set(flow.dels.tolist()))
    dels = [base_id, N + 4, N + 21]
    tcur = flow.tart2.insert_items(extra).delete_items(dels)
    jcur = flow.jart2.insert_items(jnp.asarray(extra)).delete_items(dels)
    got = reconcile_compaction(flow.tart2, tcur, compacted(flow)[1])
    want = jax_reconcile(flow.jart2, jcur, compacted(flow)[0])
    assert got.fingerprint == want.fingerprint
    np.testing.assert_array_equal(got.effective_ids(), want.effective_ids())
    assert reconcile_compaction(flow.tart2, flow.tart2, got) is got
    with pytest.raises(ValueError, match="not a delta-free compaction"):
        reconcile_compaction(flow.tart2, tcur, flow.tart2)


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_bookkeeping_errors_match_reference(flow):
    t, j = flow.tart2, flow.jart2
    full = np.ones((13, D), np.float32)
    cases = [
        (lambda a, x: a.insert_items(x(full)), "buffer full"),
        (lambda a, x: a.insert_items(x(full[:2, :5])), "must be"),
        (lambda a, x: a.insert_items(x(full.astype(np.int32))), "floating"),
        (lambda a, x: a.delete_items([N + 20]), "item ids"),
        (lambda a, x: a.delete_items([-1, 4]), "item ids"),
    ]
    for fn, what in cases:
        want = _message(lambda: fn(j, jnp.asarray))
        got = _message(lambda: fn(t, lambda a: a))
        assert got == want and what in got, (got, want)
    with pytest.raises(ValueError, match=re.escape(_message(
            lambda: JaxEngine(j.config.replace(k_max=20)).attach(j)))):
        RkMIPSEngine(t.config.replace(k_max=20), device="cpu").attach(t)
    # the knobs that change no answer pass the guard, in both packages
    ok = dict(delta_capacity=8, scan_precision="int8", scan_budget=3)
    JaxEngine(j.config.replace(**ok)).attach(j)
    RkMIPSEngine(t.config.replace(**ok), device="cpu").attach(t)
    with pytest.raises(TypeError):
        RkMIPSEngine(t.config, device="cpu").attach(object())
    with pytest.raises(ValueError, match="keep must be >= 1"):
        t.save(str(flow.root / "never"), keep=0)


def test_artifacts_are_values(flow):
    before = flow.tart.fingerprint
    deleted = flow.tart.deleted.clone()
    child = flow.tart.delete_items([1, 2]).insert_items(flow.rows[:3])
    assert flow.tart.fingerprint == before and not flow.tart.has_pending
    assert torch.equal(flow.tart.deleted, deleted)
    assert child.fingerprint != before
    assert child.base_fingerprint == flow.tart.base_fingerprint
    assert child.delta_used == 3 and child.n_items == N - 2 + 3
    assert child.delete_items([1]).fingerprint == child.fingerprint
    codes, proj_q = flow.tart.serving_codes()
    want_codes, want_proj = flow.jart.serving_codes()
    codes = codes.numpy().view(np.uint32)
    # the reference scatters its padding rows' code (item id -1) onto the
    # last base row: ``.at[-1]`` wraps; that row is held against its code
    # in the forward index instead
    np.testing.assert_array_equal(codes[:-1], np.asarray(want_codes)[:-1])
    kids = np.asarray(flow.jart.kmips_index.item_ids)
    np.testing.assert_array_equal(codes[-1], np.asarray(
        flow.jart.kmips_index.codes)[kids == N - 1][0])
    assert torch.equal(proj_q, torch.from_numpy(np.array(want_proj)))
    items, proj, fp = child.serving_corpus()
    assert items.shape == (N + 1, D) and fp == child.fingerprint
    assert torch.equal(proj, flow.tart.kmips_proj)
    assert child.serving_base()[2] == flow.tart.base_fingerprint
    assert "pending=yes" in repr(child)


def test_save_keeps_the_newest_steps_and_the_saved_one(flow, tmp_path):
    art = flow.tart
    for step in (1, 2, 3):
        art.save(str(tmp_path), step=step)
    art.save(str(tmp_path), step=0, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000000",
                                            "step_00000002",
                                            "step_00000003"]
    assert IndexArtifact.load(str(tmp_path), device="cpu").fingerprint \
        == art.fingerprint
    with pytest.raises(FileNotFoundError):
        IndexArtifact.load(str(tmp_path / "none"), device="cpu")


def test_build_sah_index_equals_sah_build():
    items, users = mf_data(12, 600, 500, D)
    cfg = get_config("sah").replace(k_max=10, tile=128)
    index, timings = build_sah_index(
        torch.from_numpy(items), torch.from_numpy(users),
        torch.Generator().manual_seed(1), config=cfg)
    want = sah.build(torch.from_numpy(items), torch.from_numpy(users),
                     generator=torch.Generator().manual_seed(1),
                     **cfg.build_kwargs())
    for a, b in zip(index._replace(alsh=None), want._replace(alsh=None)):
        if a is not None:
            assert torch.equal(a, b)
    for a, b in zip(index.alsh, want.alsh):
        assert torch.equal(a, b)
    assert timings.total >= timings.item_codes >= 0 and not timings.sharded
    with pytest.raises(ValueError, match="build knob k_max"):
        build_sah_index(torch.from_numpy(items), torch.from_numpy(users),
                        config=types.SimpleNamespace(
                            **{**cfg.__dict__, "k_max": 0}))


def test_artifact_defaults_to_the_card_and_refuses_bad_input():
    items, users = mf_data(13, 300, 200, 8)
    if torch.cuda.is_available():
        assert IndexArtifact.build(items, users).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device by default"):
            IndexArtifact.build(items, users)
    with pytest.raises(ValueError, match="kmips_proj must be"):
        IndexArtifact.build(items, users, kmips_proj=np.ones((9, 64)),
                            device="cpu")
    with pytest.raises(ValueError, match="delta_capacity"):
        IndexArtifact.build(items, users, delta_capacity=0, device="cpu")
    with pytest.raises(ValueError, match="two uint32 words"):
        IndexArtifact.build(items, users, key=np.array([1, 2, 3]),
                            device="cpu")
    art = IndexArtifact.build(items, None, torch.Generator(), device="cpu")
    assert art.kmips_index is not None and art.index is None
    with pytest.raises(RuntimeError, match="kMIPS-only"):
        art.query_view()
    # a kMIPS-only engine folds staged rows into kmips too
    eng = RkMIPSEngine.from_artifact(art.insert_items(items[:1] * 50),
                                     device="cpu")
    top = eng.kmips(items[:2], 1)
    assert top.ids.tolist() == [[300], [300]]


# -- riders -------------------------------------------------------------------


def test_transforms_match_reference():
    rng = np.random.default_rng(7)
    items = rng.standard_normal((50, 6)).astype(np.float32)
    mask = rng.random(50) < 0.6
    c, r = jtransforms.centroid_and_radius(jnp.asarray(items))
    tc, tr = transforms.centroid_and_radius(torch.from_numpy(items))
    np.testing.assert_allclose(tc.numpy(), np.asarray(c), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(tr), float(r), rtol=1e-5)
    mc, mr = jtransforms.centroid_and_radius(jnp.asarray(items),
                                             jnp.asarray(mask))
    tmc, tmr = transforms.centroid_and_radius(torch.from_numpy(items),
                                              torch.from_numpy(mask))
    np.testing.assert_allclose(tmc.numpy(), np.asarray(mc), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(tmr), float(mr), rtol=1e-5)
    pairs = [
        (jtransforms.sat_item_transform(jnp.asarray(items), c, r),
         transforms.sat_item_transform(torch.from_numpy(items),
                                       torch.from_numpy(np.array(c)),
                                       torch.tensor(float(r)))),
        (jtransforms.qnf_item_transform(jnp.asarray(items), r),
         transforms.qnf_item_transform(torch.from_numpy(items),
                                       torch.tensor(float(r)))),
        (jtransforms.user_transform(jnp.asarray(items), jnp.asarray(
            np.float32(2.5))), transforms.user_transform(
             torch.from_numpy(items), torch.tensor(2.5))),
    ]
    for want, got in pairs:
        assert got.shape == (50, 7)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def test_checkpoint_round_trip_and_prune(tmp_path):
    tree = {"b/x": np.arange(6, dtype=np.int32).reshape(2, 3),
            "a": np.ones(4, np.float32), "c": np.array([True, False])}
    for step in (3, 5, 9):
        path = checkpoint.save(str(tmp_path), step, tree,
                               metadata={"step": step})
    assert path.endswith("step_00000009")
    assert checkpoint.latest_step(str(tmp_path)) == 9
    manifest = checkpoint.read_manifest(str(tmp_path), 9)
    assert manifest["index"]["a"]["file"] == "a00000"
    assert manifest["index"]["c"] == {"file": "a00002", "shape": [2],
                                      "dtype": "bool"}
    got, meta = checkpoint.restore(str(tmp_path), 5, tree)
    assert meta == {"step": 5}
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(got[k], tree[k])
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(str(tmp_path), 5, {"a": np.ones(3)})
    with pytest.raises(KeyError):
        checkpoint.restore(str(tmp_path), 5, {"zz": np.ones(3)})
    os.makedirs(tmp_path / ".tmp_step_00000011")      # an unfinished write
    checkpoint.prune(str(tmp_path), keep=1, protect=(3,))
    assert sorted(os.listdir(tmp_path)) == [".tmp_step_00000011",
                                            "step_00000003", "step_00000009"]
    assert checkpoint.latest_step(str(tmp_path / "none")) is None


def test_checkpoints_cross_between_the_packages(tmp_path):
    tree = {"w": np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4),
            "ids": np.arange(5, dtype=np.uint32), "m": np.eye(2, dtype=bool)}
    jckpt.save(str(tmp_path / "ref"), 2, {k: jnp.asarray(v)
                                          for k, v in tree.items()},
               metadata={"by": "reference"})
    got, meta = checkpoint.restore(str(tmp_path / "ref"), 2, tree)
    assert meta == {"by": "reference"}
    for k in tree:
        assert got[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(got[k], tree[k])
    checkpoint.save(str(tmp_path / "port"), 4, tree, metadata={"by": "port"})
    back, meta = jckpt.restore(str(tmp_path / "port"), 4, tree)
    assert meta == {"by": "port"}
    for k in tree:
        np.testing.assert_array_equal(np.asarray(back[k]), tree[k])
    assert (checkpoint.read_manifest(str(tmp_path / "port"), 4)["index"]
            == jckpt.read_manifest(str(tmp_path / "ref"), 2)["index"])

"""Query side of the PyTorch port (``repro_torch.core.sah``) on an index
that the JAX reference built, carried across by ``index_from_numpy``.

Against the reference (``repro.core.sah.rkmips_batch``) on the same
index and queries:

* predictions are equal for k in {1, 10, 50} and the "sah" and
  "simpfer" presets, except at lanes traced to float ties: a lane may
  differ only where a deciding inner product or bound lies within float
  rounding of its threshold, or where the lane's SRP user code differs by
  a bit whose score lies within rounding of 0. Every such lane is counted
  and checked; an F1 check alone would hide a wrong lane;
* the plan counters (blocks_alive, users_alive, n_no_lb, n_yes_norm,
  n_scan) are equal under the same rule: every lane on which the two
  plans disagree is traced.

Inside the port, bitwise: the batched driver equals the per-query
driver, ``scan_budget=0`` equals no budget, and the chunk size does not
change a prediction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sah as jsah
from repro.engine.artifact import _flatten_named
from repro.engine.config import get_config as jax_get_config
from repro.kernels import ref as jax_ref
from repro_torch.core import sah
from repro_torch.kernels import ref as plain
from test_torch_core import mf_data

N, M, D = 1500, 3000, 16
BUILD = dict(k_max=50, tile=256, leaf_size=32, n_bits=128)
TIE_EPS = 1e-5
_ref_plan = jax.jit(jsah._plan_one, static_argnums=(2, 3))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's host loops issue many tiny ops: one intra-op thread per
    test process keeps a many-worker run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def queries_for(items, seed=1):
    """Three queries from the top 2% of items by norm (large audiences,
    deep scans) and two from the top 20% (the paper's draw)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(-np.linalg.norm(items, axis=1), kind="stable")
    top = order[rng.choice(int(0.02 * len(items)), 3, replace=False)]
    mid = order[rng.choice(int(0.2 * len(items)), 2, replace=False)]
    return items[np.concatenate([top, mid])]


def reference_index_arrays(index):
    """The reference index as numpy arrays under the artifact's names."""
    flat = {}
    _flatten_named("index/", index, flat)
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.fixture(scope="module")
def corpus():
    items, users = mf_data(0, N, M, D)
    return items, users, queries_for(items)


@pytest.fixture(scope="module")
def indexes(corpus):
    """preset -> (reference index, port index carried across, arrays)."""
    items, users, _ = corpus
    out = {}
    for preset in ("sah", "simpfer"):
        cfg = jax_get_config(preset).replace(**BUILD)
        ref_idx = jsah.build(jnp.asarray(items), jnp.asarray(users),
                             jax.random.PRNGKey(3), **cfg.build_kwargs())
        arrays = reference_index_arrays(ref_idx)
        out[preset] = (ref_idx, sah.index_from_numpy(arrays, "cpu"), arrays)
    return out


def query_kwargs(preset):
    cfg = jax_get_config(preset)
    return dict(n_cand=cfg.n_cand, scan=cfg.scan, chunk=cfg.chunk,
                tie_eps=TIE_EPS)


class Tracer:
    """Decides whether one lane's disagreement is a float tie."""

    def __init__(self, arrays, q, k):
        self.users = arrays["index/users"].astype(np.float64)
        live = arrays["index/alsh/item_mask"]
        self.items = np.concatenate(
            [arrays["index/top_items"],
             arrays["index/alsh/items"][live]]).astype(np.float64)
        self.lb = arrays["index/user_lb"][:, k - 1].astype(np.float64)
        self.kth_norm = float(arrays["index/top_norms"][k - 1])
        self.proj = arrays["index/alsh/proj"][:-1]
        self.q = q.astype(np.float64)
        qn = float(np.linalg.norm(self.q))
        self.eps = TIE_EPS * qn
        # float32 error of one d-term dot product, for tau and for <u, p>
        self.tol = (8 * self.users.shape[1] * 2.0 ** -24
                    * (np.linalg.norm(self.items, axis=1).max() + qn))
        # the cone bounds go through arccos/cos: half the planner's slack
        self.bound_tol = 1e-4 * qn

    def code_flip(self, j):
        u = self.users[j:j + 1].astype(np.float32)
        mine = plain.srp_hash(torch.from_numpy(u), torch.from_numpy(
            self.proj)).numpy().view(np.uint32)
        theirs = np.asarray(jax_ref.srp_hash(jnp.asarray(u),
                                             jnp.asarray(self.proj)))
        return not np.array_equal(mine, theirs)

    def lane(self, j, vals):
        """Reason the lane may differ, or None if it is not a tie. ``vals``
        holds the lane's cone bounds and the limits they are held to."""
        tau = float(self.users[j] @ self.q)
        thr = tau + self.eps
        if abs(self.lb[j] - thr) <= self.tol:
            return "lower bound at tau"
        if abs(tau - self.kth_norm) <= self.tol:
            return "tau at the k-th norm"
        for name in ("vec_ub", "node_ub"):
            if abs(vals[name] - vals["lim_" + name]) <= self.bound_tol:
                return f"{name} at its limit"
        if np.any(np.abs(self.items @ self.users[j] - thr) <= self.tol):
            return "an item's inner product at tau"
        if self.code_flip(j):
            return "user code bit at 0"
        return None


def lane_values(index, arrays, q, k):
    """Per-lane bound values and their limits, for the tracer."""
    from repro_torch.core import cone
    qt = torch.from_numpy(q)
    qn = torch.linalg.norm(qt)
    blocks = cone.ConeBlocks(perm=index.user_ids, center=index.center,
                             omega=index.omega, theta=index.theta)
    node_ub, phi = cone.node_upper_bound(qt, blocks)
    vec_ub = cone.vector_upper_bound(qn, phi, blocks)
    leaf = index.n_users // index.n_blocks
    slack = float(2e-4 * qn + TIE_EPS * qn)
    return {
        "node_ub": np.repeat(node_ub.numpy(), leaf),
        "lim_node_ub": np.repeat(arrays["index/block_lb"][:, k - 1], leaf)
        - slack,
        "vec_ub": vec_ub.numpy(),
        "lim_vec_ub": arrays["index/user_lb"][:, k - 1] - slack,
    }


def trace(arrays, index, q, k, lanes):
    """Assert each of ``lanes`` (cone-leaf positions) of query q is a
    float tie; returns how many there were."""
    if len(lanes):
        tracer = Tracer(arrays, q, k)
        vals = lane_values(index, arrays, q, k)
        for j in lanes:
            reason = tracer.lane(j, {key: v[j] for key, v in vals.items()})
            assert reason is not None, (j, k)
    return len(lanes)


def assert_traced(arrays, index, queries, k, ref_lanes, port_lanes):
    """Every (query, lane) where the boolean arrays differ is a float tie;
    returns the number of such lanes."""
    return sum(trace(arrays, index, q, k,
                     np.nonzero(ref_lanes[i] != port_lanes[i])[0])
               for i, q in enumerate(queries))


@pytest.mark.parametrize("preset", ["sah", "simpfer"])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_predictions_match_reference(indexes, corpus, preset, k):
    ref_idx, idx, arrays = indexes[preset]
    queries = corpus[2]
    kw = query_kwargs(preset)
    want, _ = jsah.rkmips_batch(ref_idx, jnp.asarray(queries), k, **kw)
    got, stats = sah.rkmips_batch(idx, torch.from_numpy(queries), k, **kw)
    want = np.asarray(want)
    n_tied = assert_traced(arrays, idx, queries, k, want, got.numpy())
    assert n_tied <= 0.001 * want.size, n_tied
    if k == 50:
        assert int(stats.n_scan.sum()) > 0         # the item scan ran
        assert want.sum() > 0


@pytest.mark.parametrize("preset", ["sah", "simpfer"])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_plan_counters_match_reference(indexes, corpus, preset, k):
    ref_idx, idx, arrays = indexes[preset]
    queries = corpus[2]
    plan = sah.rkmips_plan(idx, torch.from_numpy(queries), k,
                           tie_eps=TIE_EPS)
    mask = arrays["index/user_mask"]
    leaf = idx.n_users // idx.n_blocks
    _, jstats = jsah.rkmips_batch(ref_idx, jnp.asarray(queries), k,
                                  **query_kwargs(preset))
    ref_lanes = {f: [] for f in ("block_alive", "user_alive", "no_lb",
                                 "yes_norm", "undecided")}
    port_lanes = {f: [] for f in ref_lanes}
    for i, q in enumerate(queries):
        r = _ref_plan(ref_idx, jnp.asarray(q), k, TIE_EPS)
        p = sah._plan_one(idx, torch.from_numpy(q), k, TIE_EPS)
        for f, rv in zip(("undecided", "block_alive", "user_alive", "no_lb",
                          "yes_norm"), (r[3], r[5], r[6], r[7], r[8])):
            rv, pv = np.asarray(rv), getattr(p, f).numpy()
            if f == "block_alive":
                rv, pv = np.repeat(rv, leaf), np.repeat(pv, leaf)
            elif f in ("no_lb", "yes_norm"):
                rv, pv = rv & mask, pv & mask
            ref_lanes[f].append(rv)
            port_lanes[f].append(pv)
    for f in ref_lanes:
        assert_traced(arrays, idx, queries, k, np.stack(ref_lanes[f]),
                      np.stack(port_lanes[f]))
    counters = {"blocks_alive": "block_alive", "users_alive": "user_alive",
                "n_no_lb": "no_lb", "n_yes_norm": "yes_norm",
                "n_scan": "undecided"}
    for counter, f in counters.items():
        want = np.asarray(getattr(jstats, counter))
        got = getattr(plan, counter).numpy()
        per_lane = np.stack(port_lanes[f]).sum(1)
        if f == "block_alive":
            per_lane //= leaf
        np.testing.assert_array_equal(got, per_lane)
        n_diff = (np.stack(ref_lanes[f]) != np.stack(port_lanes[f])).sum(1)
        if f == "block_alive":
            n_diff //= leaf
        assert np.all(np.abs(got - want) <= n_diff), counter


def test_batched_equals_per_query_bitwise(indexes, corpus):
    _, idx, _ = indexes["sah"]
    queries = torch.from_numpy(corpus[2])
    kw = query_kwargs("sah")
    for k in (10, 50):
        pred, stats = sah.rkmips_batch(idx, queries, k, **kw)
        for i in range(len(queries)):
            p1, s1 = sah.rkmips(idx, queries[i], k, **kw)
            assert torch.equal(pred[i], p1)
            for f in ("blocks_alive", "users_alive", "n_no_lb",
                      "n_yes_norm", "n_scan"):
                assert int(getattr(stats, f)[i]) == getattr(s1, f), f
            one, s_one = sah.rkmips_batch(idx, queries[i:i + 1], k, **kw)
            assert torch.equal(one[0], p1)
            assert int(s_one.tiles_scanned[0]) == s1.tiles_scanned
            assert int(s_one.chunks[0]) == s1.chunks


def test_scan_budget_zero_is_no_budget_and_budget_is_conservative(
        indexes, corpus):
    ref_idx, idx, arrays = indexes["sah"]
    queries = corpus[2]
    qt = torch.from_numpy(queries)
    kw = query_kwargs("sah")
    free, s_free = sah.rkmips_batch(idx, qt, 50, **kw)
    zero, s_zero = sah.rkmips_batch(idx, qt, 50, scan_budget=0, **kw)
    huge, s_huge = sah.rkmips_batch(idx, qt, 50, scan_budget=10 ** 6, **kw)
    assert torch.equal(free, zero) and torch.equal(free, huge)
    for a, b in zip(s_free, s_zero):
        assert torch.equal(a, b)
    assert int(s_huge.truncated.sum()) == 0
    tight, s_tight = sah.rkmips_batch(idx, qt, 50, scan_budget=1, **kw)
    assert bool((tight <= free).all())                  # only drops users
    assert int(s_tight.truncated.sum()) > 0
    want, j_tight = jsah.rkmips_batch(ref_idx, jnp.asarray(queries), 50,
                                      scan_budget=1, **kw)
    np.testing.assert_array_equal(s_tight.truncated.numpy(),
                                  np.asarray(j_tight.truncated))
    assert_traced(arrays, idx, queries, 50, np.asarray(want), tight.numpy())


def test_predictions_do_not_depend_on_chunk_size(indexes, corpus):
    _, idx, _ = indexes["sah"]
    qt = torch.from_numpy(corpus[2])
    kw = query_kwargs("sah")
    base, _ = sah.rkmips_batch(idx, qt, 50, **kw)
    for chunk in (64, 100, 1000):
        got, _ = sah.rkmips_batch(idx, qt, 50, **dict(kw, chunk=chunk))
        assert torch.equal(got, base), chunk


def test_index_from_numpy_keeps_bits_and_dtypes(indexes):
    _, idx, arrays = indexes["sah"]
    assert idx.alsh.codes.dtype == torch.int32
    np.testing.assert_array_equal(idx.alsh.codes.numpy().view(np.uint32),
                                  arrays["index/alsh/codes"])
    assert idx.user_mask.dtype == torch.bool
    assert idx.alsh.item_mask.dtype == torch.bool
    assert idx.alsh.qitems.dtype == torch.int8
    assert idx.user_ids.dtype == torch.int32
    assert idx.alsh.n_parts.shape == ()


def test_predictions_to_original_drops_phantom_ids(indexes, corpus):
    _, idx, _ = indexes["sah"]
    ids = idx.user_ids.clone()
    ids[:3] = torch.tensor([-1, M, M + 5], dtype=torch.int32)
    phantom = idx._replace(user_ids=ids)
    pred = torch.ones(2, idx.n_users, dtype=torch.bool)
    out = sah.predictions_to_original(phantom, pred, M)
    want = torch.zeros(M, dtype=torch.bool)
    want[ids[idx.user_mask & (ids >= 0) & (ids < M)].long()] = True
    assert out.shape == (2, M) and torch.equal(out[0], want)
    jout = jsah.predictions_to_original(
        jsah.SAHIndex(*[None] * 2, jnp.asarray(ids.numpy()),
                      jnp.asarray(idx.user_mask.numpy()), *[None] * 8),
        jnp.asarray(pred.numpy()), M)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


def test_tile_candidates_match_reference_exactly(indexes):
    """Fed the reference's own user codes, every tile's candidate rows and
    their order equal ``lax.top_k``'s (ties toward the lower row), though
    Hamming distances tie everywhere."""
    from repro.core import sa_alsh as jalsh
    from repro_torch.core import sa_alsh
    ref_idx, idx, _ = indexes["sah"]
    users = ref_idx.users[:256]
    ucodes = jalsh.user_codes(ref_idx.alsh, users)
    tucodes = torch.from_numpy(np.array(ucodes).view(np.int32))
    for t in range(int(ref_idx.alsh.tile_max_norm.shape[0])):
        _, valid, local = jalsh._tile_candidates(ref_idx.alsh, ucodes, users,
                                                 t, n_cand=64, scan="sketch")
        _, tvalid, tlocal = sa_alsh._tile_candidates(
            idx.alsh, tucodes, idx.users[:256], t, n_cand=64, scan="sketch")
        np.testing.assert_array_equal(tlocal.numpy(), np.asarray(local))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(valid))
    dist = plain.hamming_scores(tucodes, idx.alsh.codes[:256])
    assert len(torch.unique(dist[0])) < 256          # ties are present


def test_batch_guard_and_int8_refusal(indexes):
    _, idx, _ = indexes["sah"]
    huge = idx._replace(users=torch.zeros(1, D).expand(2 ** 30, D))
    with pytest.raises(ValueError, match="int32 flat work queue"):
        sah.rkmips_plan(huge, torch.ones(2, D), 10)
    with pytest.raises(NotImplementedError, match="next slice"):
        sah.rkmips_batch(idx, torch.ones(1, D), 10, scan_precision="int8")
    with pytest.raises(ValueError, match="scan_precision must be one of"):
        sah.rkmips_batch(idx, torch.ones(1, D), 10, scan_precision="bf16")

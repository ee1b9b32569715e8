"""Forward kMIPS in the PyTorch port (``sa_alsh.kmips_topk``,
``sa_alsh.merge_topk``, ``RkMIPSEngine.kmips``) held against the JAX
reference.

* On the reference's own forward index, carried across with
  ``sah.alsh_from_numpy``, ``kmips_topk`` gives the reference's ids except
  at traced float ties: where two items' float64 inner products with the
  query lie within float32 rounding of each other, or where the query's
  SRP code differs from the reference's by a bit within rounding of 0.
  Values are allclose at rtol 1e-5, atol 1e-6; ``tiles_visited`` is equal.
* ``merge_topk`` moves no float, so it equals the reference exactly,
  duplicates included (the lower position first).
* The engine: ``kmips`` under the "exact" preset answers as the
  reference engine does (same rule), and under "sah" it is bitwise the
  core scan on the engine's own lazily built forward index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sa_alsh as jalsh
from repro.core import srp as jsrp
from repro.engine.artifact import KMIPS_KEY_TAG, _flatten_named
from repro.engine.config import get_config as jax_get_config
from repro.engine.engine import RkMIPSEngine as JaxEngine
from repro.kernels import ref as jax_ref
from repro_torch import RkMIPSEngine, get_config
from repro_torch.core import sa_alsh, sah
from repro_torch.kernels import ops
from test_torch_core import mf_data

N, M, D = 1500, 400, 16
TILE = 256
KEY = jax.random.PRNGKey(5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    """Items, query rows (users), the reference forward index and its
    projection, and the port's copy of that index."""
    items, users = mf_data(7, N, M, D)
    cfg = jax_get_config("sah").replace(tile=TILE)
    kkey = jax.random.fold_in(KEY, KMIPS_KEY_TAG)
    ref_idx = jalsh.build_index(jnp.asarray(items), kkey,
                                **cfg.kmips_build_kwargs(N))
    flat = {}
    _flatten_named("kmips/", ref_idx, flat)
    arrays = {key: np.asarray(v) for key, v in flat.items()}
    proj = np.array(jsrp.make_projection(kkey, D + 1, 128))
    return (items, users[:64], ref_idx,
            sah.alsh_from_numpy(arrays, "kmips/", "cpu"), proj)


def traced_differences(items, queries, proj, got_ids, want_ids):
    """Number of (query, position) pairs where the id lists differ; each
    must be a float tie of the two items' IPs, or the query's SRP code
    must differ from the reference's (a bit within rounding of 0)."""
    items64 = items.astype(np.float64)
    n = 0
    for qi, pos in zip(*np.nonzero(got_ids != want_ids)):
        q = queries[qi].astype(np.float64)
        a, b = items64[got_ids[qi, pos]], items64[want_ids[qi, pos]]
        tol = 8 * len(q) * 2.0 ** -24 * (np.abs(q * a).sum()
                                         + np.abs(q * b).sum())
        mine = ops.srp_hash(torch.from_numpy(queries[qi:qi + 1]),
                            torch.from_numpy(proj[:-1])).numpy()
        theirs = np.asarray(jax_ref.srp_hash(jnp.asarray(queries[qi:qi + 1]),
                                             jnp.asarray(proj[:-1])))
        assert (abs(q @ a - q @ b) <= tol
                or not np.array_equal(mine.view(np.uint32), theirs)), (qi,
                                                                       pos)
        n += 1
    return n


@pytest.mark.parametrize("scan", ["sketch", "exact"])
@pytest.mark.parametrize("k", [1, 10])
def test_kmips_topk_matches_reference(corpus, scan, k):
    items, queries, ref_idx, idx, proj = corpus
    want_v, want_i, want_t = jalsh.kmips_topk(ref_idx, jnp.asarray(queries),
                                              k, n_cand=64, scan=scan)
    vals, ids, tiles = sa_alsh.kmips_topk(idx, torch.from_numpy(queries), k,
                                          n_cand=64, scan=scan)
    assert ids.dtype == torch.int32 and vals.shape == (len(queries), k)
    want_i = np.asarray(want_i)
    n_tied = traced_differences(items, queries, proj, ids.numpy(), want_i)
    assert n_tied <= 0.01 * want_i.size, n_tied
    np.testing.assert_allclose(np.sort(vals.numpy(), 1),
                               np.sort(np.asarray(want_v), 1), rtol=1e-5,
                               atol=1e-6)
    assert tiles == int(want_t) or n_tied
    if scan == "exact":       # exact answers: the brute-force top-k
        bv, bi = ops.ip_topk(torch.from_numpy(queries),
                             torch.from_numpy(items), k)
        assert traced_differences(items, queries, proj, ids.numpy(),
                                  bi.numpy()) <= 0.01 * want_i.size
        torch.testing.assert_close(vals, bv, rtol=1e-5, atol=1e-6)


def test_merge_topk_matches_reference_with_duplicates():
    rng = np.random.default_rng(3)
    vals = np.round(rng.standard_normal((6, 12)), 1).astype(np.float32)
    vals[:, 5:] = -np.inf
    extra = np.round(rng.standard_normal((6, 9)), 1).astype(np.float32)
    extra[0] = vals[0, 0]                          # ties across the two
    ids = rng.integers(0, 100, (6, 12)).astype(np.int32)
    extra_ids = rng.integers(100, 200, (6, 9)).astype(np.int32)
    for k in (1, 7, 21):
        got_v, got_i = sa_alsh.merge_topk(*map(torch.from_numpy, (
            vals, ids, extra, extra_ids)), k)
        want_v, want_i = jalsh.merge_topk(*map(jnp.asarray, (
            vals, ids, extra, extra_ids)), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_engine_kmips_exact_preset_matches_reference_engine(corpus):
    items, queries, _, _, proj = corpus
    jeng = JaxEngine(jax_get_config("exact").replace(tile=TILE)).build(
        jnp.asarray(items), None, KEY)
    teng = RkMIPSEngine(get_config("exact").replace(tile=TILE),
                        device="cpu").build(items, None, kmips_proj=proj)
    np.testing.assert_array_equal(teng.kmips_index.item_ids.numpy(),
                                  np.asarray(jeng.kmips_index.item_ids))
    want = jeng.kmips(jnp.asarray(queries), 10)
    got = teng.kmips(queries, 10)
    assert traced_differences(items, queries, proj, got.ids.numpy(),
                              np.asarray(want.ids)) <= 0.01 * got.ids.numel()
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-5, atol=1e-6)
    assert got.tiles_visited == want.tiles_visited
    assert got.seconds > 0 and got.k == 10
    with pytest.raises(RuntimeError, match="not built for reverse"):
        teng.query_batch(queries[:1], 10)


def test_engine_kmips_is_the_core_scan_on_its_forward_index(corpus):
    items, queries, _, _, proj = corpus
    eng = RkMIPSEngine(get_config("sah").replace(tile=TILE, k_max=10),
                       device="cpu")
    eng.build(items, mf_data(8, 8, 300, D)[1], torch.Generator(),
              kmips_proj=proj)
    assert eng.artifact.kmips_index is None      # built at the first kmips
    res = eng.kmips(queries, 10)
    idx = eng.kmips_index
    vals, ids, tiles = sa_alsh.kmips_topk(idx, torch.from_numpy(queries), 10)
    assert torch.equal(res.values, vals) and torch.equal(res.ids, ids)
    assert res.tiles_visited == tiles
    one = eng.kmips(queries[3], 10)
    assert one.ids.shape == (10,) and torch.equal(one.ids, ids[3])
    deep = eng.kmips(queries, 10, n_cand=10 ** 6)      # clamped to the tile
    exact = sa_alsh.kmips_topk(idx, torch.from_numpy(queries), 10,
                               n_cand=TILE)
    assert torch.equal(deep.ids, exact[1])
    with pytest.raises(ValueError, match="outside"):
        eng.kmips(queries, N + 1)

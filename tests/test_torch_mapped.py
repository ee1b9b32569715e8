"""The legacy mapped reverse driver of the port: ``core/sah.py::
rkmips_batch_mapped`` (the per-query driver run for each query in turn,
the reference's ``lax.map``) and ``RkMIPSEngine.query_batch_mapped``.

* Inside the port, bitwise: the mapped driver's predictions and plan
  counters equal the batched driver's (``tests/test_batched.py:59``),
  under f32 and int8; with one query every counter does.
* Against the reference, on the index the reference built
  (``index_from_numpy``): the reference's ``rkmips_batch_mapped``
  predictions and every counter, exactly.
* Through the engine, with staged changes attached: ``query_batch_mapped``
  equals ``query_batch`` (``tests/test_artifact.py:241-256``), and its
  signature counter counts once per (batch shape, k).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sah as jsah
from repro_torch.core import sah
from repro_torch.engine import IndexArtifact, RkMIPSEngine, get_config
from test_torch_core import mf_data
from test_torch_sah import reference_index_arrays

LOGICAL = ("blocks_alive", "users_alive", "n_no_lb", "n_yes_norm", "n_scan",
           "truncated")
BUILD = dict(k_max=8, n_top=8, tile=64, leaf_size=8, n_bits=32)


@pytest.fixture(scope="module")
def built():
    """The reference's index over a small MF corpus, carried across, and
    five queries from the items (the tie path: ip == tau lanes)."""
    items, users = mf_data(17, 384, 512, 16)
    rng = np.random.default_rng(17)
    queries = items[rng.choice(items.shape[0], 5, replace=False)]
    ref_idx = jsah.build(jnp.asarray(items), jnp.asarray(users),
                         jax.random.PRNGKey(17), **BUILD)
    idx = sah.index_from_numpy(reference_index_arrays(ref_idx), "cpu")
    return ref_idx, idx, queries


def _equal_stats(got, want, fields):
    for f in fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_mapped_equals_batched(built, precision):
    _, idx, queries = built
    q = torch.from_numpy(queries)
    kw = dict(n_cand=16, scan_precision=precision)
    bp, bs = sah.rkmips_batch(idx, q, 3, **kw)
    mp, ms = sah.rkmips_batch_mapped(idx, q, 3, **kw)
    assert torch.equal(bp, mp)
    _equal_stats(ms, bs, LOGICAL)
    assert all(getattr(ms, f).dtype == torch.int32 for f in ms._fields)
    # one query: the packing counters agree too
    bp1, bs1 = sah.rkmips_batch(idx, q[:1], 3, **kw)
    mp1, ms1 = sah.rkmips_batch_mapped(idx, q[:1], 3, **kw)
    assert torch.equal(bp1, mp1)
    _equal_stats(ms1, bs1, sah.QueryStats._fields)


def test_mapped_equals_reference_mapped(built):
    ref_idx, idx, queries = built
    rp, rs = jsah.rkmips_batch_mapped(ref_idx, jnp.asarray(queries), 3,
                                      n_cand=16)
    mp, ms = sah.rkmips_batch_mapped(idx, torch.from_numpy(queries), 3,
                                     n_cand=16)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(rp))
    for f in sah.QueryStats._fields:
        np.testing.assert_array_equal(getattr(ms, f).numpy(),
                                      np.asarray(getattr(rs, f)), err_msg=f)


@pytest.mark.parametrize("precision", ["f32", "int8"])
def test_engine_mapped_with_staged_changes(precision):
    """Staged inserts and deletes (a P' member among them) served by the
    mapped driver as by the batched one; one signature per (batch, k)."""
    items, users = mf_data(23, 120, 64, 16)
    cfg = get_config("sah").replace(
        tile=32, n_bits=32, k_max=8, n_top=8, leaf_size=8, n_cand=16,
        delta_capacity=8, scan_precision=precision)
    gen = torch.Generator().manual_seed(31)
    art = IndexArtifact.build(items, users, gen, config=cfg, device="cpu")
    rows = np.random.default_rng(11).standard_normal((5, 16)) * 1.2
    top = int(np.argmax(np.linalg.norm(items, axis=1)))
    art = art.insert_items(rows.astype(np.float32)).delete_items(
        [0, 7, 55, top, items.shape[0] + 1])
    eng = RkMIPSEngine.from_artifact(art, device="cpu")
    queries = items[[3, 9, top, 40]]
    rb = eng.query_batch(queries, 3)
    rm = eng.query_batch_mapped(queries, 3)
    assert torch.equal(rm.predictions, rb.predictions)
    _equal_stats(rm.stats, rb.stats, LOGICAL)
    assert rm.funnel.scan_lanes == rb.funnel.scan_lanes
    assert eng.rkmips_mapped_compile_count == 1
    eng.query_batch_mapped(queries, 3)
    assert eng.rkmips_mapped_compile_count == 1
    eng.query_batch_mapped(queries, 4)
    eng.query_batch_mapped(queries[:2], 3)
    assert eng.rkmips_mapped_compile_count == 3
    with pytest.raises(ValueError, match="outside"):
        eng.query_batch_mapped(queries, 9)

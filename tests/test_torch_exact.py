"""The port's exact oracles, metrics and SRP helper that the examples and
benchmarks call (``repro_torch.core.exact.kmips`` / ``rkmips_decision``,
``metrics.recall_at_k``, ``srp.srp_codes``), and the package's front
door, held against the JAX reference on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro.core as jcore
from repro.core import exact as jexact
from repro.core import metrics as jmetrics
from repro.core import srp as jsrp
import repro_torch
import repro_torch.core as core
from repro_torch.core import exact, metrics, srp


def rows(rng, n, d, dups=()):
    """Gaussian rows with exact duplicates (i, j): row j copies row i."""
    x = rng.standard_normal((n, d)).astype(np.float32)
    for i, j in dups:
        x[j] = x[i]
    return x


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 10), (2, 25)])
def test_kmips_matches_reference(seed, k):
    """Ids exactly (ties to the lower index, as ``lax.top_k``), values
    within 1e-6. Duplicated items make exact ties."""
    rng = np.random.default_rng(seed)
    items = rows(rng, 300, 16, dups=[(3, 5), (3, 200), (40, 41)])
    queries = np.concatenate([rows(rng, 6, 16), items[[3, 40]]])
    want_v, want_i = jexact.kmips(jnp.asarray(items), jnp.asarray(queries),
                                  k)
    got_v, got_i = exact.kmips(torch.from_numpy(items),
                               torch.from_numpy(queries), k)
    assert got_i.dtype == torch.int64 and got_v.shape == (8, k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                               rtol=0, atol=1e-6)
    # equal values answer in index order: items 3, 5 and 200 are one row,
    # and query 6 is that row, which its copies answer together
    dup = [i for i in got_i[6].tolist() if i in (3, 5, 200)]
    assert dup and dup == [3, 5, 200][:len(dup)]


@pytest.mark.parametrize("tie_eps", [0.0, 1e-6])
@pytest.mark.parametrize("seed", [0, 1])
def test_rkmips_decision_matches_reference(seed, tie_eps):
    """The strict count ``ip > tau + tie_eps * ||q||``, exactly, for each
    query; and the batch oracle's row."""
    rng = np.random.default_rng(10 + seed)
    items = np.abs(rows(rng, 200, 12))
    users = np.abs(rows(rng, 500, 12))
    users /= np.linalg.norm(users, axis=1, keepdims=True)
    queries = np.abs(rows(rng, 5, 12)) * 1.5
    t_items, t_users = torch.from_numpy(items), torch.from_numpy(users)
    for q in queries:
        want = np.asarray(jexact.rkmips_decision(
            jnp.asarray(items), jnp.asarray(users), jnp.asarray(q), 10,
            tie_eps=tie_eps))
        got = exact.rkmips_decision(t_items, t_users, torch.from_numpy(q),
                                    10, tie_eps=tie_eps)
        assert got.dtype == torch.bool and got.shape == (500,)
        np.testing.assert_array_equal(got.numpy(), want)
        batch = exact.rkmips_batch(t_items, t_users,
                                   torch.from_numpy(q)[None], 10, tie_eps)
        assert torch.equal(batch[0], got)
    assert 0 < int(got.sum()) < 500       # the draw decides both ways


def test_recall_at_k_matches_reference():
    rng = np.random.default_rng(3)
    true_idx = np.stack([rng.permutation(50)[:10] for _ in range(7)])
    pred_idx = np.where(rng.random((7, 10)) < 0.4,
                        rng.integers(0, 50, (7, 10)), true_idx)
    pred_idx[0] = true_idx[0]
    pred_idx[1] = true_idx[1] + 100
    want = np.asarray(jmetrics.recall_at_k(jnp.asarray(pred_idx),
                                           jnp.asarray(true_idx)))
    got = metrics.recall_at_k(torch.from_numpy(pred_idx),
                              torch.from_numpy(true_idx))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 1.0 and got[1] == 0.0
    # 9 hits of 10: 9 * (1/10) in float32, one ulp above 9 / 10
    assert (got.numpy() == np.float32(9) * np.float32(1 / 10)).any()
    # leading batch axes, as the reference allows
    got3 = metrics.recall_at_k(torch.from_numpy(pred_idx)[None],
                               torch.from_numpy(true_idx)[None])
    np.testing.assert_array_equal(got3[0].numpy(), want)


def test_srp_codes_match_reference_bitwise():
    """On rows whose every projection lies away from 0 (a sign there is
    the rounding's to decide), the codes equal the reference's bit for
    bit (int32 views of its uint32 words)."""
    rng = np.random.default_rng(4)
    x = rows(rng, 400, 17)
    proj = rows(rng, 17, 96)
    far = (np.abs(x.astype(np.float64) @ proj.astype(np.float64))
           > 1e-3).all(axis=1)
    x = x[far]
    assert x.shape[0] > 300
    want = np.asarray(jsrp.srp_codes(jnp.asarray(x), jnp.asarray(proj)))
    got = srp.srp_codes(torch.from_numpy(x), torch.from_numpy(proj))
    assert got.dtype == torch.int32 and got.shape == (x.shape[0], 3)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


def test_front_door_holds_the_references_names():
    """``repro_torch.__all__`` holds every name of ``repro.__all__``, each
    the engine layer's object, beside the LM entry points; ``core`` lists
    the reference's nine modules."""
    assert set(repro.__all__) <= set(repro_torch.__all__)
    from repro_torch import engine
    for name in repro.__all__:
        assert getattr(repro_torch, name) is getattr(engine, name), name
    for name in ("LMConfig", "decode_step", "init_params", "prefill"):
        assert name in repro_torch.__all__
    assert core.__all__ == jcore.__all__
    for name in core.__all__:
        assert getattr(core, name).__name__ == f"repro_torch.core.{name}"

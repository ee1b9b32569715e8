"""Build side of the PyTorch port (``repro_torch.core``) held against the
JAX reference (``repro.core``) on the same numpy inputs.

Torch cannot replay ``jax.random``, so the reference's two random draws
(the SRP projection from ``build_keys``'s item key, the cone tree's
initial permutation from its cone key) are made with JAX and injected
into the port's build. Then:

* integer arrays are equal: item_ids, part_id, n_parts, user_ids,
  user_mask, top_ids, qitems, and the codes up to flips whose score lies
  within float32 rounding of 0;
* float arrays are ``allclose`` at rtol 1e-5, atol 1e-6: the two
  frameworks reduce (norms, means, sums of squares, GEMMs) in different
  orders, which moves the last bits of a float32 result.

The inputs hold exact duplicate items and users, so norm and split-key
ties are present and the stable sorts are exercised.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cone as jcone
from repro.core import partitions as jparts
from repro.core import sa_alsh as jalsh
from repro.core import sah as jsah
from repro.core import simpfer as jsimpfer
from repro.core import srp as jsrp
from repro_torch.core import cone, partitions, sa_alsh, sah, simpfer, srp

RTOL, ATOL = 1e-5, 1e-6
INT_FIELDS = {"item_ids", "part_id", "n_parts", "item_mask", "user_ids",
              "user_mask", "top_ids", "qitems"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's host loops issue many tiny ops: one intra-op thread per
    test process keeps a many-worker run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mf_data(seed, n, m, d, rank=8):
    """MF-like factors (the reference generator's recipe, in numpy), with
    exact duplicates among the items and among the users."""
    rng = np.random.default_rng(seed)
    h = np.abs(rng.standard_normal((rank, d)))

    def rows(r):
        w = np.abs(rng.standard_normal((r, rank)))
        x = w @ h / rank + np.abs(rng.standard_normal((r, d)))
        return (x * np.exp(0.1 * rng.standard_normal((r, 1)))).astype(
            np.float32)

    items, users = rows(n), rows(m)
    items[5] = items[3]
    items[n // 2] = items[1]
    users[7] = users[2]
    users[m - 1] = users[0]
    return items, users


def reference_draws(key, d, n_bits, m, leaf_size):
    """The projection and cone permutation the reference build draws."""
    k_idx, k_cone = jsah.build_keys(key)
    proj = np.array(jsrp.make_projection(k_idx, d + 1, n_bits))
    m_pad = jcone.pad_users(jnp.zeros((m, 1)), leaf_size)[0].shape[0]
    perm = np.array(jax.random.permutation(k_cone, m_pad))
    return proj, perm


def assert_codes_close(got, want, rows, proj, slack_rows=None):
    """int32 codes == uint32 codes except for flips whose float64 score
    lies within 8 * D * 2**-24 * sum|x_i p_i| of 0, widened by
    sum|dx_i p_i| when the hashed rows themselves differ by dx."""
    got = got.view(np.uint32)
    g = np.unpackbits(got.view(np.uint8), bitorder="little", axis=1)
    w = np.unpackbits(want.view(np.uint8), bitorder="little", axis=1)
    r, c = np.nonzero(g != w)
    terms = rows[r].astype(np.float64) * proj[:, c].T.astype(np.float64)
    bound = 8 * rows.shape[1] * 2.0 ** -24 * np.abs(terms).sum(-1)
    if slack_rows is not None:
        bound += np.abs((slack_rows[r].astype(np.float64)
                         - rows[r]) * proj[:, c].T).sum(-1)
    assert np.all(np.abs(terms.sum(-1)) <= bound)
    return len(r)


def assert_field(name, got, want):
    got = got.cpu().numpy()
    want = np.asarray(want)
    if want.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.shape == want.shape, name
    if name in INT_FIELDS or want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("norms", [
    [9.0, 8.0, 4.5, 4.5, 4.0, 2.0, 1.1, 1.0, 0.5],   # cut exactly at b * M
    [8.0, 8.0, 8.0, 8.0],                          # one partition
    [2.0 ** -i for i in range(12)],                # clamps at max_partitions
    [3.0, 1.0, 0.0, 0.0, 0.0],                     # zero norms open anew
])
def test_assign_partitions_matches_reference(norms):
    x = np.asarray(norms, np.float32)
    want_pid, want_n = jparts.assign_partitions(jnp.asarray(x), 0.5, 6)
    pid, n_parts = partitions.assign_partitions(torch.from_numpy(x), 0.5, 6)
    np.testing.assert_array_equal(pid.numpy(), np.asarray(want_pid))
    assert int(n_parts) == int(want_n)


def test_build_partitions_matches_reference():
    items, _ = mf_data(0, 600, 8, 12)
    items[:50] *= 4.0                              # two norm ranges at least
    norms = np.linalg.norm(items, axis=1)
    order = np.argsort(-norms, kind="stable")
    xs, ns = items[order], norms[order].astype(np.float32)
    want = jparts.build_partitions(jnp.asarray(xs), jnp.asarray(ns), 0.5, 16)
    got = partitions.build_partitions(torch.from_numpy(xs),
                                      torch.from_numpy(ns), 0.5, 16)
    assert int(got.n_parts) >= 2
    for f in jparts.NormPartitions._fields:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_cone_blocks_match_reference_on_the_same_permutation():
    _, users = mf_data(1, 8, 1000, 16)
    unit = users / np.linalg.norm(users, axis=1, keepdims=True)
    key = jax.random.PRNGKey(7)
    want, wpad, wmask = jcone.build_cone_blocks(jnp.asarray(unit), key, 32)
    perm = np.array(jax.random.permutation(key, wpad.shape[0]))
    got, gpad, gmask = cone.build_cone_blocks(torch.from_numpy(unit),
                                              torch.from_numpy(perm), 32)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    np.testing.assert_array_equal(gpad.numpy(), np.asarray(wpad))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    for f in ("center", "omega", "theta"):
        assert_field(f, getattr(got, f), getattr(want, f))
    with pytest.raises(ValueError, match="permutation of the 1024"):
        cone.build_cone_blocks(torch.from_numpy(unit), torch.arange(1000))


def test_cone_bounds_match_reference():
    _, users = mf_data(2, 8, 256, 16)
    unit = users / np.linalg.norm(users, axis=1, keepdims=True)
    blocks, _, _ = jcone.norm_blocks(jnp.asarray(unit), 32)
    tb, _, _ = cone.norm_blocks(torch.from_numpy(unit), 32)
    q = np.abs(np.random.default_rng(3).standard_normal(16)).astype(
        np.float32)
    ub, phi = jcone.node_upper_bound(jnp.asarray(q), blocks)
    tub, tphi = cone.node_upper_bound(torch.from_numpy(q), tb)
    assert_field("node_ub", tub, ub)
    assert_field("phi", tphi, phi)
    vub = jcone.vector_upper_bound(jnp.linalg.norm(jnp.asarray(q)), phi,
                                   blocks)
    tvub = cone.vector_upper_bound(torch.linalg.norm(torch.from_numpy(q)),
                                   tphi, tb)
    assert_field("vec_ub", tvub, vub)
    # Lemma 3 really bounds every user's inner product
    assert bool((tvub >= torch.from_numpy(unit @ q) - 1e-4).all())


def test_simpfer_bounds_match_reference():
    items, users = mf_data(3, 100, 512, 16)
    unit = users / np.linalg.norm(users, axis=1, keepdims=True)
    lb = simpfer.user_lower_bounds(torch.from_numpy(unit),
                                   torch.from_numpy(items), 10)
    want = jsimpfer.user_lower_bounds(jnp.asarray(unit), jnp.asarray(items),
                                      10)
    assert_field("user_lb", lb, want)
    assert_field("block_lb", simpfer.block_lower_bounds(lb, 16),
                 jsimpfer.block_lower_bounds(want, 16))
    tau = np.asarray(want)[:, 4].copy()             # ties with L_u[4] exactly
    np.testing.assert_array_equal(
        simpfer.init_count(torch.from_numpy(np.array(want)),
                           torch.from_numpy(tau)).numpy(),
        np.asarray(jsimpfer.init_count(want, jnp.asarray(tau))))


@pytest.mark.parametrize("method,kw", [
    ("sah", dict(transform="sat", blocking="cone")),
    ("h2-cone", dict(transform="qnf", blocking="cone")),
    ("sa-simpfer", dict(transform="sat", blocking="norm")),
])
def test_build_matches_reference(method, kw):
    n, m, d = 1500, 2000, 16
    items, users = mf_data(4, n, m, d)
    key = jax.random.PRNGKey(11)
    kw = dict(kw, k_max=20, tile=256, leaf_size=32, n_bits=128)
    want = jsah.build(jnp.asarray(items), jnp.asarray(users), key, **kw)
    proj, perm = reference_draws(key, d, 128, m, 32)
    got = sah.build(torch.from_numpy(items), torch.from_numpy(users),
                    proj=torch.from_numpy(proj),
                    cone_order=torch.from_numpy(perm), **kw)
    for f in jsah.SAHIndex._fields:
        if f != "alsh":
            assert_field(f, getattr(got, f), getattr(want, f))
    for f in jalsh.SAALSHIndex._fields:
        if f != "codes":
            assert_field(f"alsh.{f}", getattr(got.alsh, f),
                         getattr(want.alsh, f))
    # the codes hash the transformed rows; those are allclose, not equal
    n_top = 2 * kw["k_max"]
    rest = items[np.argsort(-np.linalg.norm(items, axis=1),
                            kind="stable")][n_top:]
    prep_j = jalsh.prepare_items(jnp.asarray(rest), tile=256,
                                 transform=kw["transform"])
    prep_t = sa_alsh.prepare_items(torch.from_numpy(rest), tile=256,
                                   transform=kw["transform"])
    rows_j = np.asarray(prep_j.transformed)
    rows_t = prep_t.transformed.numpy()
    # shifted rows are p - c: their error is the centroid's, so it is
    # relative to |c| (the reference sums a partition sequentially, the
    # port pairwise), not to the small |p - c|
    c_scale = float(np.abs(np.asarray(want.alsh.part_centroid)).max())
    np.testing.assert_allclose(rows_t[:, :-1], rows_j[:, :-1], rtol=RTOL,
                               atol=RTOL * c_scale)
    # the appended coordinate is sqrt(R^2 - ||p - c||^2): near the sphere
    # the sqrt magnifies a rounding difference, so compare its square
    ext2_scale = float((rows_j ** 2).sum(1).max())
    np.testing.assert_allclose(rows_t[:, -1] ** 2, rows_j[:, -1] ** 2,
                               rtol=RTOL, atol=RTOL * ext2_scale)
    flips = assert_codes_close(got.alsh.codes.numpy(),
                               np.asarray(want.alsh.codes), rows_t, proj,
                               slack_rows=rows_j)
    assert flips <= 4, flips


def test_build_draws_from_the_generator():
    items, users = mf_data(5, 700, 300, 8)
    a = sah.build(torch.from_numpy(items), torch.from_numpy(users),
                  generator=torch.Generator().manual_seed(3), k_max=10,
                  tile=128)
    b = sah.build(torch.from_numpy(items), torch.from_numpy(users),
                  generator=torch.Generator().manual_seed(3), k_max=10,
                  tile=128)
    for x, y in zip(a._replace(alsh=None), b._replace(alsh=None)):
        if x is not None:
            assert torch.equal(x, y)
    assert torch.equal(a.alsh.codes, b.alsh.codes)
    assert a.alsh.proj.shape == (9, 128)
    assert sorted(a.user_ids[a.user_mask].tolist()) == list(range(300))
    with pytest.raises(ValueError, match="needs a generator or a proj"):
        sah.build(torch.from_numpy(items), torch.from_numpy(users))


def test_quantize_matches_reference():
    rows = np.random.default_rng(6).standard_normal((64, 10)).astype(
        np.float32)
    rows[3] = 0.0
    pid = np.repeat(np.arange(4, dtype=np.int32), 16)
    for got, want in (
            (sa_alsh.quantize_rows(torch.from_numpy(rows)),
             jalsh.quantize_rows(jnp.asarray(rows))),
            (sa_alsh.quantize_partitioned(torch.from_numpy(rows),
                                          torch.from_numpy(pid), 6),
             jalsh.quantize_partitioned(jnp.asarray(rows), jnp.asarray(pid),
                                        6))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_srp_helpers():
    g = torch.Generator().manual_seed(0)
    p = srp.make_projection(g, 5, 64, "cpu")
    assert p.shape == (5, 64) and p.dtype == torch.float32
    with pytest.raises(ValueError, match="multiple of 32"):
        srp.make_projection(g, 5, 40, "cpu")
    signs = torch.rand(4, 64) < 0.5
    codes = srp.pack_signs(signs)
    want = jsrp.pack_signs(jnp.asarray(signs.numpy()))
    np.testing.assert_array_equal(codes.numpy().view(np.uint32),
                                  np.asarray(want))
    np.testing.assert_array_equal(
        srp.hamming_distance(codes, codes[:2]).numpy(),
        np.asarray(jsrp.hamming_distance(want, want[:2])))

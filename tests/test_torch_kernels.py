"""Kernel layer of the PyTorch port (``repro_torch.kernels``) held against
the JAX reference (``repro.kernels``).

On the CPU the plain PyTorch versions run: Hamming distances must equal
the reference's ``ref.hamming_scores`` and its Pallas kernel in interpret
mode exactly; SRP codes must equal the reference bit for bit except for
flips whose float64 score lies within ``8 * d * 2**-24 * sum_i |x_i p_i|``
of 0 (the two sum in different orders). Codes travel as int32 bit views
and are compared through ``.view(np.uint32)``. ``fused_scan`` candidates
and ``ip_topk`` ids must equal the reference's exactly (ties toward the
lower row); their floats are allclose at rtol 1e-5, atol 1e-5. The CUDA
``ip_topk``'s split-and-merge algorithm is held in plain PyTorch
(``ref.ip_topk_partials`` then ``ref.merge_topk``) against ``ref.ip_topk``
bit for bit and the reference's Pallas kernel plus its merge. The plain
``flash_attention`` must match the reference's ``ref.flash_attention`` and
its Pallas kernel in interpret mode within the reference's own tolerances
(atol 5e-5 in float32, 3e-2 in bf16).

``ref.hamming_nearest`` (the plain version of the selecting Hamming
kernel) must equal the reference's ``hamming_scores`` + mask +
``lax.top_k(-dist, n_cand)`` exactly, ties toward the lower row.

Tests marked ``gpu`` hold each CUDA kernel against its plain version and
skip where no CUDA device is present (decided in a fixture, so every
worker collects the same tests): integers exactly, SRP codes, and the
``fused_scan`` and ``ip_topk`` floats bit for bit (kernel and plain
version both round each product and each sum in index order),
``ip_topk``'s raw per-split lists too. The flash attention kernel
sums in another order than its plain version: float32 within atol 5e-5;
bf16 within ``2**-6 * |plain| + 1e-3`` (two bf16 ulps: both outputs are
rounded to bf16 from float32 values that differ by rounding). They need no JAX: the
reference is imported by the ``jx`` fixture, so this file also runs where
only the port is installed (``pytest -m gpu tests/test_torch_kernels.py``).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core import sa_alsh
from repro_torch.kernels import fused_scan, hamming_scan, ip_topk, ops, ref
from repro_torch.kernels import flash_attention, srp_hash
from repro_torch.models import attention


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's kernel modules."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import flash_attention as jax_flash
    from repro.kernels import fused_scan as jax_fused
    from repro.kernels import hamming_scan as jax_hamming
    from repro.kernels import ip_topk as jax_ip_topk
    from repro.kernels import ref as jax_ref
    from repro.kernels import srp_hash as jax_srp
    from repro.kernels.ops import _merge_topk
    return types.SimpleNamespace(jnp=jnp, hamming=jax_hamming, ref=jax_ref,
                                 srp=jax_srp, fused=jax_fused,
                                 ip_topk=jax_ip_topk, merge=_merge_topk,
                                 flash=jax_flash)


def _u32(rng, shape):
    return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _t(codes_u32):
    return torch.from_numpy(codes_u32.view(np.int32))


def _flip_bound_check(x, proj, got_u32, want_u32):
    """Number of differing bits; each must lie within the rounding bound."""
    got = np.unpackbits(got_u32.view(np.uint8), bitorder="little", axis=1)
    want = np.unpackbits(want_u32.view(np.uint8), bitorder="little", axis=1)
    rows, cols = np.nonzero(got != want)
    terms = x[rows].astype(np.float64) * proj[:, cols].T.astype(np.float64)
    score = np.abs(terms.sum(-1))
    bound = 8 * x.shape[1] * 2.0 ** -24 * np.abs(terms).sum(-1)
    assert np.all(score <= bound), (score, bound)
    return len(rows)


@pytest.mark.parametrize("w", range(1, 9))
def test_hamming_plain_equals_reference_and_pallas(jx, w):
    jnp, jax_ref, jax_hamming = jx.jnp, jx.ref, jx.hamming
    rng = np.random.default_rng(w)
    q, n = _u32(rng, (16, w)), _u32(rng, (64, w))
    q[0] = 0                        # all-zero codes
    n[0] = 0xFFFFFFFF               # all-one codes
    q[1] = 0x80000000               # only the high bit
    got = ref.hamming_scores(_t(q), _t(n)).numpy()
    want = np.asarray(jax_ref.hamming_scores(jnp.asarray(q), jnp.asarray(n)))
    pallas = np.asarray(jax_hamming.hamming_scores(
        jnp.asarray(q), jnp.asarray(n), block_q=8, block_n=32,
        interpret=True))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    assert got[0, 0] == 32 * w
    assert got[1, 0] == 31 * w


def test_hamming_extremes_and_high_bit(jx):
    jnp, jax_ref = jx.jnp, jx.ref
    zero = np.zeros((3, 4), np.uint32)
    ones = np.full((5, 4), 0xFFFFFFFF, np.uint32)
    high = np.full((2, 4), 0x80000000, np.uint32)
    d = ref.hamming_scores(_t(np.concatenate([zero, high])),
                           _t(np.concatenate([ones, zero]))).numpy()
    want = np.asarray(jax_ref.hamming_scores(
        jnp.asarray(np.concatenate([zero, high])),
        jnp.asarray(np.concatenate([ones, zero]))))
    np.testing.assert_array_equal(d, want)
    assert (d[:3, :5] == 128).all() and (d[3:, 5:] == 4).all()


def test_popcount_and_pack_signs():
    rng = np.random.default_rng(0)
    words = _u32(rng, (1000,))
    want = np.array([bin(int(x)).count("1") for x in words])
    np.testing.assert_array_equal(ref.popcount32(_t(words)).numpy(), want)
    signs = rng.random((7, 96)) < 0.5
    packed = ref.pack_signs(torch.from_numpy(signs)).numpy().view(np.uint32)
    bits = np.unpackbits(packed.view(np.uint8), bitorder="little", axis=1)
    np.testing.assert_array_equal(bits.astype(bool), signs)


@pytest.mark.parametrize("n,d,b", [(64, 16, 128), (300, 33, 64),
                                   (256, 100, 128), (17, 7, 32)])
def test_srp_plain_matches_reference_up_to_rounding_flips(jx, n, d, b):
    jnp, jax_ref, jax_srp = jx.jnp, jx.ref, jx.srp
    rng = np.random.default_rng(n + d + b)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[0] = 0.0                      # all scores +0.0: every bit set
    x[1] = -0.0                     # -0.0 >= 0 holds too
    proj = rng.standard_normal((d, b)).astype(np.float32)
    got = ref.srp_hash(torch.from_numpy(x), torch.from_numpy(proj))
    got = got.numpy().view(np.uint32)
    want = np.asarray(jax_ref.srp_hash(jnp.asarray(x), jnp.asarray(proj)))
    flips = _flip_bound_check(x, proj, got, want)
    assert flips <= n * b // 1000, flips
    assert (got[:2] == 0xFFFFFFFF).all()
    if n % 8 == 0:
        pallas = np.asarray(jax_srp.srp_hash(jnp.asarray(x), jnp.asarray(proj),
                                             block_n=8, interpret=True))
        _flip_bound_check(x, proj, got, pallas)


def test_srp_nan_rows_set_no_bit(jx):
    jnp, jax_ref = jx.jnp, jx.ref
    x = np.full((2, 5), np.nan, np.float32)
    proj = np.ones((5, 32), np.float32)
    got = ref.srp_hash(torch.from_numpy(x), torch.from_numpy(proj)).numpy()
    want = np.asarray(jax_ref.srp_hash(jnp.asarray(x), jnp.asarray(proj)))
    np.testing.assert_array_equal(got.view(np.uint32), want)
    assert (got == 0).all()


def test_srp_plain_rows_do_not_depend_on_the_batch():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((500, 40)).astype(np.float32))
    proj = torch.from_numpy(rng.standard_normal((40, 128)).astype(np.float32))
    full = ref.srp_hash(x, proj)
    for lo, hi in ((0, 1), (17, 273), (256, 500)):
        assert torch.equal(ref.srp_hash(x[lo:hi], proj), full[lo:hi])


def _fused_inputs(seed, c, t, w, d, live=0.8, patterns=0):
    """numpy inputs of one fused_scan call: (ucodes, item_codes) uint32,
    mask bool, qitems int8, qscale f32, users f32. With ``patterns`` > 0
    the item codes repeat that many rows, so each lane's distances take at
    most that many values and long runs of rows tie."""
    rng = np.random.default_rng(seed)
    codes = _u32(rng, (t, w))
    if patterns:
        codes = codes[rng.integers(0, patterns, size=t)]
    return (_u32(rng, (c, w)), codes, rng.random(t) < live,
            rng.integers(-127, 128, size=(t, d)).astype(np.int8),
            rng.uniform(0.0, 0.1, size=t).astype(np.float32),
            rng.standard_normal((c, d)).astype(np.float32))


def _torch_fused(args, device="cpu"):
    uc, ic, mask, qi, qs, us = args
    return (_t(uc).to(device), _t(ic).to(device),
            torch.from_numpy(mask).to(device),
            torch.from_numpy(qi).to(device), torch.from_numpy(qs).to(device),
            torch.from_numpy(us).to(device))


def _jax_fused(jnp, args):
    return [jnp.asarray(a) for a in args]


# (C, T, W, d, n_cand): prime sizes, n_cand == T (every row selected),
# one word and eight
_FUSED_SHAPES = [(16, 97, 3, 19, 7), (8, 256, 4, 32, 16), (4, 513, 1, 5, 64),
                 (32, 144, 8, 24, 13), (3, 31, 2, 17, 31)]


@pytest.mark.parametrize("c,t,w,d,n_cand", _FUSED_SHAPES)
def test_fused_scan_plain_equals_reference(jx, c, t, w, d, n_cand):
    args = _fused_inputs(c + t + d, c, t, w, d)
    cand, qips = ref.fused_scan(*_torch_fused(args), n_cand)
    jargs = _jax_fused(jx.jnp, args)
    rc, rq = jx.ref.fused_scan(*jargs, n_cand)
    lc, lq = jx.fused.fused_scan_lax(*jargs, n_cand=n_cand)
    assert cand.dtype == torch.int32 and qips.dtype == torch.float32
    for want_c, want_q in ((rc, rq), (lc, lq)):
        np.testing.assert_array_equal(cand.numpy(), np.asarray(want_c))
        np.testing.assert_allclose(qips.numpy(), np.asarray(want_q),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("live", [0.8, 0.0, 0.05])
def test_fused_scan_plain_equals_pallas_interpret(jx, live):
    """At a tiny shape against the Pallas kernel run in interpret mode;
    live=0 masks every row (candidates are then rows 0..n_cand-1) and
    live=0.05 leaves fewer live rows than n_cand."""
    args = _fused_inputs(7, 8, 64, 2, 9, live=live)
    cand, qips = ref.fused_scan(*_torch_fused(args), 12)
    pc, pq = jx.fused.fused_scan_tiles(*_jax_fused(jx.jnp, args), n_cand=12,
                                       block_q=4, interpret=True)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(pc))
    np.testing.assert_allclose(qips.numpy(), np.asarray(pq), rtol=1e-5,
                               atol=1e-5)
    mask = args[2]
    n_live = int(mask.sum())
    if n_live < 12:                    # live rows first, then masked rows
        assert mask[cand.numpy()[:, :n_live]].all()
        assert not mask[cand.numpy()[:, n_live:]].any()
    if live == 0.0:
        np.testing.assert_array_equal(cand.numpy(),
                                      np.tile(np.arange(12), (8, 1)))


@pytest.mark.parametrize("t,n_cand,patterns", [(512, 100, 3), (300, 64, 1),
                                               (1000, 333, 5)])
def test_fused_scan_plain_ties_equal_reference(jx, t, n_cand, patterns):
    """Long runs of equal distances (the item codes repeat a few rows), cut
    by n_cand inside a run: candidates must equal the reference's and its
    lax mirror's exactly, the lower row first in each run."""
    args = _fused_inputs(t + patterns, 6, t, 2, 11, patterns=patterns)
    cand, qips = ref.fused_scan(*_torch_fused(args), n_cand)
    jargs = _jax_fused(jx.jnp, args)
    for want_c, want_q in (jx.ref.fused_scan(*jargs, n_cand),
                           jx.fused.fused_scan_lax(*jargs, n_cand=n_cand)):
        np.testing.assert_array_equal(cand.numpy(), np.asarray(want_c))
        np.testing.assert_allclose(qips.numpy(), np.asarray(want_q),
                                   rtol=1e-5, atol=1e-5)
    dist = ref.hamming_scores(*_torch_fused(args)[:2])
    dist = torch.where(torch.from_numpy(args[2])[None, :], dist,
                       ref.BIG_HAMMING).gather(1, cand.long())
    assert bool((dist[:, 1:] >= dist[:, :-1]).all())
    tied = dist[:, 1:] == dist[:, :-1]
    assert bool((cand[:, 1:] > cand[:, :-1])[tied].all()) and tied.any()


# (C, T, W, n_cand, live, patterns): W 1 to 8, odd T, n_cand == T, every
# row masked, few live rows, and long runs of equal distances (the item
# codes repeat a few rows) cut by n_cand inside a run
_NEAREST_CASES = [(16, 97, 1, 7, 0.8, 0), (8, 256, 2, 16, 0.8, 0),
                  (4, 513, 3, 64, 0.8, 0), (6, 300, 4, 64, 0.8, 3),
                  (5, 144, 5, 13, 0.8, 1), (3, 31, 6, 31, 0.8, 0),
                  (8, 64, 7, 12, 0.0, 0), (8, 64, 8, 12, 0.05, 0),
                  (4, 1000, 8, 333, 0.9, 5)]


@pytest.mark.parametrize("c,t,w,n_cand,live,patterns", _NEAREST_CASES)
def test_hamming_nearest_plain_equals_reference(jx, c, t, w, n_cand, live,
                                                patterns):
    """``ref.hamming_nearest`` against the reference's ``hamming_scores``,
    its mask sentinel and ``lax.top_k(-dist, n_cand)`` (the selection of
    ``src/repro/core/sa_alsh.py::_tile_candidates``): rows exactly, in
    order; ``ops`` on the CPU takes it and launches nothing."""
    import jax
    jnp = jx.jnp
    uc, ic, mask = _fused_inputs(c * t + w, c, t, w, 1, live=live,
                                 patterns=patterns)[:3]
    tuc, tic, tmask = _t(uc), _t(ic), torch.from_numpy(mask)
    got = ref.hamming_nearest(tuc, tic, tmask, n_cand)
    assert got.dtype == torch.int32 and got.shape == (c, n_cand)
    dist = jx.ref.hamming_scores(jnp.asarray(uc), jnp.asarray(ic))
    dist = jnp.where(jnp.asarray(mask)[None, :], dist, 1 << 30)
    _, want = jax.lax.top_k(-dist, n_cand)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    before = dict(ops.launch_counts)
    assert torch.equal(ops.hamming_nearest(tuc, tic, tmask, n_cand), got)
    assert ops.launch_counts == before
    if live == 0.0:                     # every row masked: rows in order
        assert got.tolist() == [list(range(n_cand))] * c


def _ip_inputs(seed, q, n, d, dup=False):
    rng = np.random.default_rng(seed)
    if dup:       # every query ties with the first half of the items
        return (np.ones((q, d), np.float32),
                np.concatenate([np.ones((n // 2, d)),
                                np.zeros((n - n // 2, d))]).astype(np.float32))
    return (rng.standard_normal((q, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


@pytest.mark.parametrize("q,n,d,k,dup", [(8, 1024, 32, 8, False),
                                         (5, 389, 29, 10, False),
                                         (4, 128, 16, 8, True),
                                         (3, 300, 7, 64, False)])
def test_ip_topk_plain_equals_reference(jx, q, n, d, k, dup):
    """Against the reference's exact top-k and its Pallas kernel in
    interpret mode plus merge (on a block multiple); ids exactly."""
    queries, items = _ip_inputs(q + n, q, n, d, dup)
    vals, ids = ref.ip_topk(torch.from_numpy(queries),
                            torch.from_numpy(items), k)
    assert ids.dtype == torch.int32
    jq, ji = jx.jnp.asarray(queries), jx.jnp.asarray(items)
    rv, ri = jx.ref.ip_topk(jq, ji, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=1e-5)
    bn = 32 if n % 32 == 0 else n
    tv, ti = jx.ip_topk.ip_topk_tiles(jq, ji, k, block_q=q, block_n=bn,
                                      interpret=True)
    mv, mi = jx.merge(tv, ti, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(mi))
    np.testing.assert_allclose(vals.numpy(), np.asarray(mv), rtol=1e-5,
                               atol=1e-5)


def _straddle_inputs(q, n, d, lo, hi):
    """Every query ties with items lo..hi-1 (all ones) above the rest
    (standard normal scaled down): equal values across split bounds."""
    rng = np.random.default_rng(n)
    items = (0.01 * rng.standard_normal((n, d))).astype(np.float32)
    items[lo:hi] = 1.0
    return np.ones((q, d), np.float32), items


# (q, n, d, k, splits, straddle): several split counts, a ragged last split
# (389 items: the third of 3 splits has 5), fewer items than k in the last
# split, more splits than tiles (empty splits), k equal to a split's 128
# items, and a run of equal values straddling the bounds at 128 and 256
_PARTIAL_CASES = [(5, 389, 29, 10, 1, None), (5, 389, 29, 10, 3, None),
                  (4, 1024, 32, 8, 4, None), (3, 300, 7, 64, 3, None),
                  (2, 256, 5, 20, 5, None), (3, 512, 16, 128, 4, None),
                  (4, 512, 8, 40, 4, (100, 300)),
                  (2, 300, 8, 128, 2, (0, 300))]


@pytest.mark.parametrize("q,n,d,k,splits,straddle", _PARTIAL_CASES)
def test_ip_topk_partials_merge_equal_plain_and_reference(jx, q, n, d, k,
                                                          splits, straddle):
    """The CUDA kernel's split-and-merge algorithm in plain PyTorch: each
    split's top-k (``ref.ip_topk_partials``) merged by ``ref.merge_topk``
    equals ``ref.ip_topk`` bit for bit, and the reference's Pallas kernel
    in interpret mode plus its ``_merge_topk`` (ids exactly)."""
    if straddle:
        queries, items = _straddle_inputs(q, n, d, *straddle)
    else:
        queries, items = _ip_inputs(q + n + splits, q, n, d)
    tq, ti = torch.from_numpy(queries), torch.from_numpy(items)
    pv, pi = ref.ip_topk_partials(tq, ti, k, splits)
    assert pv.shape == pi.shape == (q, splits, k) and pi.dtype == torch.int32
    per = -(-(-(-n // ip_topk.BLOCK_N)) // splits) * ip_topk.BLOCK_N
    for s_ in range(splits):
        size = max(0, min(n, (s_ + 1) * per) - s_ * per)
        assert bool((pi[:, s_, size:] == -1).all())
        assert bool((pv[:, s_, size:] == -np.inf).all())
        live = pi[:, s_, :min(size, k)]
        assert bool(((live >= s_ * per) & (live < s_ * per + size)).all())
    vals, ids = ref.merge_topk(pv, pi, k)
    want_v, want_i = ref.ip_topk(tq, ti, k)
    assert torch.equal(ids, want_i) and torch.equal(vals, want_v)
    jq, ji = jx.jnp.asarray(queries), jx.jnp.asarray(items)
    bn = next(b for b in (32, 64, 128, n) if n % b == 0 and b >= k)
    tv, tidx = jx.ip_topk.ip_topk_tiles(jq, ji, k, block_q=q, block_n=bn,
                                        interpret=True)
    mv, mi = jx.merge(tv, tidx, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(mi))
    np.testing.assert_allclose(vals.numpy(), np.asarray(mv), rtol=1e-5,
                               atol=1e-5)
    if straddle:
        lo, hi = straddle
        assert ids[0].tolist() == list(range(lo, lo + min(k, hi - lo)))


def test_ip_topk_merge_keeps_the_lower_id_first():
    """Equal values in different splits: the merge keeps them in split
    order, which is id order, and never takes a padded slot over a live
    one."""
    vals = torch.tensor([[[5.0, 2.0, -np.inf], [5.0, 5.0, 2.0],
                          [7.0, -np.inf, -np.inf]]])
    ids = torch.tensor([[[3, 9, -1], [130, 200, 131], [300, -1, -1]]],
                       dtype=torch.int32)
    v, i = ref.merge_topk(vals, ids, 6)
    assert v.tolist() == [[7.0, 5.0, 5.0, 5.0, 2.0, 2.0]]
    assert i.tolist() == [[300, 3, 130, 200, 9, 131]]
    assert i.dtype == torch.int32


@pytest.mark.parametrize("nq,n,slots,want", [
    (4096, 17770, 264, (8, 18)), (4096, 17770, 132, (4, 35)),
    (1, 17770, 264, (139, 1)), (4096, 100, 264, (1, 1)),
    (100000, 17770, 264, (1, 139)), (256, 1000, 132, (8, 1))])
def test_ip_topk_split_count(nq, n, slots, want):
    """Splits fill the resident blocks once, are whole tiles, none empty."""
    splits, per = ip_topk.split_count(nq, n, slots)
    assert (splits, per) == want
    n_tiles = -(-n // ip_topk.BLOCK_N)
    assert (splits - 1) * per < n_tiles <= splits * per
    assert splits * -(-nq // ip_topk.BLOCK_Q) <= max(slots, -(-nq // 128))


def test_topk_stable_keeps_the_lower_position_first():
    v = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0, 1.0]])
    vals, pos = ref.topk_stable(v, 4)
    assert pos.tolist() == [[1, 2, 4, 0]] and vals.tolist() == [[3, 3, 3, 1]]
    assert ref.nearest_rows(torch.tensor([[2, 1, 1, 0, 1]]), 3).tolist() \
        == [[3, 1, 2]]


def test_ops_dispatch_by_device():
    rng = np.random.default_rng(1)
    q, n = _t(_u32(rng, (4, 4))), _t(_u32(rng, (9, 4)))
    before = dict(ops.launch_counts)
    assert torch.equal(ops.hamming_scores(q, n), ref.hamming_scores(q, n))
    x, p = torch.randn(3, 5), torch.randn(5, 64)
    assert torch.equal(ops.srp_hash(x, p), ref.srp_hash(x, p))
    args = _torch_fused(_fused_inputs(2, 6, 40, 2, 5))
    for got, want in zip(ops.fused_scan(*args, n_cand=7),
                         ref.fused_scan(*args, 7)):
        assert torch.equal(got, want)
    for got, want in zip(ops.ip_topk(x, x, 2), ref.ip_topk(x, x, 2)):
        assert torch.equal(got, want)
    # the meta device (the dry run's trace) takes the plain versions too
    meta = ops.hamming_scores(q.to("meta"), n.to("meta"))
    assert meta.device.type == "meta" and meta.shape == (4, 9)
    vals, ids = ops.ip_topk(x.to("meta"), x.to("meta"), 2)
    assert vals.shape == ids.shape == (3, 2) and ids.dtype == torch.int32
    rows = ops.hamming_nearest(q.to("meta"), n.to("meta"),
                               torch.ones(9, dtype=torch.bool, device="meta"),
                               3)
    assert rows.device.type == "meta" and rows.shape == (4, 3)
    assert ops.launch_counts == before          # the plain path launches none
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops._route(types.SimpleNamespace(device=torch.device("xpu")),
                   "hamming_scores")


def test_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back to the plain version."""
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        hamming_scan.hamming_scores(torch.zeros(2, 4, dtype=torch.int32),
                                    torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        srp_hash.srp_hash(torch.zeros(2, 4), torch.zeros(4, 32))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        hamming_scan.hamming_nearest(torch.zeros(2, 4, dtype=torch.int32),
                                     torch.zeros(3, 4, dtype=torch.int32),
                                     torch.ones(3, dtype=torch.bool), 2)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        fused_scan.fused_scan(*_torch_fused(_fused_inputs(0, 2, 8, 1, 3)),
                              n_cand=2)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ip_topk.ip_topk_tiles(torch.zeros(2, 4), torch.zeros(3, 4), 1)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for _ in range(3)]


_FLASH_CASES = [   # tests/test_kernels.py's shapes, blocks and tolerances
    ((2, 3, 128, 32), 32, 32, True, "float32", 5e-5),
    ((1, 2, 256, 64), 64, 128, True, "float32", 5e-5),
    ((2, 2, 64, 16), 64, 16, False, "float32", 5e-5),
    ((1, 1, 128, 128), 128, 32, True, "float32", 5e-5),
    ((1, 2, 64, 32), 32, 32, True, "bfloat16", 3e-2)]


@pytest.mark.parametrize("shape,bq,bk,causal,dtype,atol", _FLASH_CASES)
def test_flash_plain_equals_reference_and_pallas(jx, shape, bq, bk, causal,
                                                 dtype, atol):
    jnp = jx.jnp
    q, k, v = _qkv(shape[2] * shape[3], shape)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    got = ref.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype
    got = got.float().numpy()
    want = np.asarray(jx.ref.flash_attention(jq, jk, jv, causal=causal),
                      np.float32)
    np.testing.assert_allclose(got, want, atol=atol)
    pallas = jx.flash.flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                                      block_k=bk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas, np.float32),
                               atol=atol)


def test_ops_flash_attention_takes_the_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, (2, 2, 40, 16)))
    before = dict(ops.launch_counts)
    for causal in (True, False):
        assert torch.equal(ops.flash_attention(q, k, v, causal=causal),
                           ref.flash_attention(q, k, v, causal=causal))
    meta = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert meta.device.type == "meta" and meta.shape == q.shape
    assert ops.launch_counts == before          # the plain path launches none
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention.flash_attention(q, k, v)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_route_grad_matches_chunked(causal):
    """On the CPU ``ops.flash_attention`` takes its plain version, which
    stays differentiable (as the reference's CPU fallback is): its
    gradients equal chunked attention's within float32 summation order."""
    qkv = [torch.from_numpy(a).requires_grad_(True)
           for a in _qkv(4, (2, 2, 40, 16))]
    cot = torch.from_numpy(_qkv(5, (2, 2, 40, 16))[0])
    got = torch.autograd.grad((ops.flash_attention(*qkv, causal=causal)
                               * cot).sum(), qkv)
    want = torch.autograd.grad((attention.chunked_attention(
        *qkv, chunk=16, causal=causal) * cot).sum(), qkv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-5)


@pytest.mark.parametrize("hkv,causal", [(1, True), (2, True), (2, False)])
def test_flash_gqa_equals_repeated_kv_and_pallas(jx, hkv, causal):
    """k and v with Hkv < H heads: ops and ref equal, bit for bit, the same
    call on repeat_kv copies, and match the reference's Pallas kernel
    (interpret mode) fed the reference's repeat_kv of the same arrays."""
    from repro.models import attention as jattn
    from repro_torch.models.attention import repeat_kv
    jnp = jx.jnp
    rng = np.random.default_rng(10 * hkv + causal)
    q = rng.standard_normal((2, 4, 64, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, hkv, 64, 32)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tkr, tvr = repeat_kv(tk, 4 // hkv), repeat_kv(tv, 4 // hkv)
    for fn in (ops.flash_attention, ref.flash_attention):
        got = fn(tq, tk, tv, causal=causal)
        assert torch.equal(got, fn(tq, tkr, tvr, causal=causal))
    pallas = jx.flash.flash_attention(
        jnp.asarray(q), jattn.repeat_kv(jnp.asarray(k), 4 // hkv),
        jattn.repeat_kv(jnp.asarray(v), 4 // hkv), causal=causal,
        block_q=32, block_k=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=5e-5)


@pytest.mark.parametrize("k_shape,match", [
    ((2, 3, 16, 8), "not a multiple"),       # H % Hkv != 0
    ((1, 2, 16, 8), "B, S and Dh"),          # B differs
    ((2, 2, 12, 8), "B, S and Dh"),          # S differs
    ((2, 2, 16, 4), "B, S and Dh")])         # Dh differs
def test_flash_attention_refuses_mismatched_kv(k_shape, match):
    q = torch.zeros(2, 4, 16, 8)
    k = torch.zeros(k_shape)
    for fn in (ops.flash_attention, ref.flash_attention):
        with pytest.raises(ValueError, match=match):
            fn(q, k, k)
    with pytest.raises(ValueError, match="one shape"):
        ops.flash_attention(q, q, q[:, :2].contiguous())


def test_build_target_follows_headers_and_flags(tmp_path, monkeypatch):
    """A library is named by its source, every csrc header and the nvcc
    flags: an edit to any of them loads no stale build."""
    from repro_torch.kernels import _build
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    assert _build._target("k") == first           # deterministic
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build._target("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = _build._target("k")
    assert third != second
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._target("k") != third
    assert _build._target("k").suffix == ".so"


def test_reset_launch_counts():
    ops.launch_counts["srp_hash"] += 3
    ops.reset_launch_counts()
    assert set(ops.launch_counts.values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("nq,n,w", [(256, 512, 4), (1, 1, 1), (33, 77, 3),
                                    (8, 4096, 8),
                                    (600000, 3, 1)])   # > 65,535 row groups
def test_cuda_hamming_equals_plain(cuda, nq, n, w):
    rng = np.random.default_rng(nq + n)
    q, it = _t(_u32(rng, (nq, w))).to(cuda), _t(_u32(rng, (n, w))).to(cuda)
    before = ops.launch_counts["hamming_scores"]
    got = ops.hamming_scores(q, it)
    torch.cuda.synchronize()
    assert ops.launch_counts["hamming_scores"] == before + 1
    assert torch.equal(got.cpu(), ref.hamming_scores(q.cpu(), it.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b,nan_rows", [
    (256, 100, 128, 0),        # the query chunk: the small tile
    (17920, 101, 128, 0),      # the build: the large tile
    (5, 3, 32, 0), (64, 700, 1024, 0),
    (7, 1, 64, 0),             # d = 1: the scalar tail alone
    (40, 12300, 96, 0),        # d > 12,288: 97 staged chunks
    (300, 33, 2048, 0),        # B = 2,048: grid.y over 64 words
    (9000, 17, 160, 0),        # large tile, ragged rows and words
    (100, 20, 64, 3)])         # NaN rows set no bit
def test_cuda_srp_equals_plain_up_to_rounding_flips(cuda, n, d, b, nan_rows):
    """Bit for bit, with no flips: the kernel rounds each product and each
    sum as ``ref.srp_scores`` does, in index order (the plain version runs
    on the card at the large shapes, elementwise ops each rounded on its
    own)."""
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[:nan_rows, d // 2] = np.nan
    proj = rng.standard_normal((d, b)).astype(np.float32)
    tx, tp = torch.from_numpy(x).to(cuda), torch.from_numpy(proj).to(cuda)
    before = ops.launch_counts["srp_hash"]
    got = ops.srp_hash(tx, tp)
    torch.cuda.synchronize()
    assert ops.launch_counts["srp_hash"] == before + 1
    plain = cuda if n * b > 1 << 20 else torch.device("cpu")
    want = ref.srp_hash(tx.to(plain), tp.to(plain))
    assert torch.equal(got.cpu(), want.cpu())
    if nan_rows:
        assert not bool(got[:nan_rows].any())


@pytest.mark.gpu
@pytest.mark.parametrize("c,t,w,n_cand,live,patterns", [
    (256, 512, 4, 64, 0.8, 0),        # the main path's shape
    (256, 512, 4, 64, 0.8, 2),        # ... with 2 distances a lane
    (64, 4096, 4, 64, 0.8, 0),        # the largest tile: 16 rows a thread
    (8, 4096, 8, 1000, 0.9, 4),       # runs of ~1,000 tied rows
    (16, 512, 4, 200, 0.8, 3),        # a cutoff run over several warps
    (5, 200, 32, 16, 0.5, 0),         # the widest code
    (7, 97, 3, 7, 0.8, 0), (3, 31, 2, 31, 0.8, 0),   # odd, n_cand = T
    (8, 64, 2, 12, 0.0, 0),           # every row masked
    (8, 64, 1, 12, 0.05, 0),          # fewer live rows than n_cand
    (4, 4096, 32, 4096, 0.9, 0)])     # n_cand = T at W 32
def test_cuda_hamming_nearest_equals_plain(cuda, c, t, w, n_cand, live,
                                           patterns):
    uc, ic, mask = _fused_inputs(c * t + w, c, t, w, 1, live=live,
                                 patterns=patterns)[:3]
    args = (_t(uc), _t(ic), torch.from_numpy(mask))
    before = dict(ops.launch_counts)
    got = ops.hamming_nearest(*(a.to(cuda) for a in args), n_cand)
    torch.cuda.synchronize()
    assert ops.launch_counts["hamming_nearest"] == \
        before["hamming_nearest"] + 1
    assert ops.launch_counts["hamming_scores"] == before["hamming_scores"]
    assert torch.equal(got.cpu(), ref.hamming_nearest(*args, n_cand))


@pytest.mark.gpu
@pytest.mark.parametrize("c,t,w,d,n_cand,live", [
    (256, 512, 4, 100, 64, 0.8),      # the main path's shape
    (16, 97, 3, 19, 7, 0.8), (3, 31, 2, 17, 31, 0.8),
    (5, 200, 32, 8, 16, 0.5),          # the widest code
    (8, 64, 2, 9, 12, 0.0),            # every row masked
    (8, 64, 2, 9, 12, 0.05),           # fewer live rows than n_cand
    (64, 4096, 8, 100, 256, 0.8),      # the largest tile: 16 rows a thread
    (32, 512, 4, 37, 64, 0.8),         # d % 4 != 0 at d > 32: byte rows
    (7, 300, 4, 100, 64, 0.8),         # an odd number of lanes
    (4, 4096, 32, 5, 4096, 0.9)])      # n_cand = T at W 32: > 48 KB smem
def test_cuda_fused_scan_equals_plain_bitwise(cuda, c, t, w, d, n_cand,
                                              live):
    args = _fused_inputs(c * t + w, c, t, w, d, live=live)
    before = ops.launch_counts["fused_scan"]
    cand, qips = ops.fused_scan(*_torch_fused(args, cuda), n_cand=n_cand)
    torch.cuda.synchronize()
    assert ops.launch_counts["fused_scan"] == before + 1
    want_c, want_q = ref.fused_scan(*_torch_fused(args), n_cand)
    assert torch.equal(cand.cpu(), want_c)
    assert torch.equal(qips.cpu(), want_q)


@pytest.mark.gpu
@pytest.mark.parametrize("c,t,w,d,n_cand,patterns", [
    (256, 512, 4, 100, 64, 2),         # the main shape, 2 distances a lane
    (16, 512, 4, 100, 200, 3),         # a cutoff run over several warps
    (8, 4096, 8, 16, 1000, 4),         # runs of ~1,000 rows, 16 a thread
    (5, 97, 3, 12, 50, 1)])            # every live row ties
def test_cuda_fused_scan_ties_across_warps_bitwise(cuda, c, t, w, d, n_cand,
                                                   patterns):
    """Runs of equal distances that span several warps' row ranges, cut by
    n_cand inside a run: slots go by bin, then warp, then row, so the
    kernel keeps the lower row first, as its plain version does."""
    args = _fused_inputs(c + t + patterns, c, t, w, d, patterns=patterns)
    cand, qips = ops.fused_scan(*_torch_fused(args, cuda), n_cand=n_cand)
    want_c, want_q = ref.fused_scan(*_torch_fused(args), n_cand)
    assert torch.equal(cand.cpu(), want_c)
    assert torch.equal(qips.cpu(), want_q)


@pytest.mark.gpu
@pytest.mark.parametrize("q,n,d,k,dup", [(64, 1000, 100, 10, False),
                                         (5, 77, 3, 1, False),
                                         (33, 300, 16, 128, False),
                                         (4, 256, 16, 8, True),
                                         (40, 129, 5, 20, False),
                                         (4096, 17770, 100, 10, False),
                                         (300, 20000, 24, 128, False),
                                         (1, 17770, 100, 10, False),
                                         (8, 4000, 16, 10, True),
                                         (4096, 100, 8, 10, False)])
def test_cuda_ip_topk_equals_plain_bitwise(cuda, q, n, d, k, dup):
    """The merged answer against ``ref.ip_topk`` and the kernel's raw
    per-split lists against ``ref.ip_topk_partials``, bit for bit: the
    forward truth's shape (4,096 x 17,770, d 100), k = 128 over many
    splits, one query, all-equal scores over many splits, and fewer items
    than one tile. The plain versions run on the CPU for the small cases
    and on the card for the large (the same elementwise ops, each rounded
    on its own)."""
    queries, items = _ip_inputs(q * n, q, n, d, dup)
    tq, ti = torch.from_numpy(queries).to(cuda), torch.from_numpy(items).to(
        cuda)
    before = ops.launch_counts["ip_topk"]
    vals, ids = ops.ip_topk(tq, ti, k)
    torch.cuda.synchronize()
    assert ops.launch_counts["ip_topk"] == before + 1
    plain = cuda if q * n > 1 << 20 else torch.device("cpu")
    pq, pi = tq.to(plain), ti.to(plain)
    want_v, want_i = ref.ip_topk(pq, pi, k)
    assert torch.equal(ids.cpu(), want_i.cpu())
    assert torch.equal(vals.cpu(), want_v.cpu())
    raw_v, raw_i = ip_topk.ip_topk_tiles(tq, ti, k)
    splits = raw_v.shape[1]
    if dup:
        assert splits > 1
    part_v, part_i = ref.ip_topk_partials(pq, pi, k, splits)
    assert torch.equal(raw_i.cpu(), part_i.cpu())
    assert torch.equal(raw_v.cpu(), part_v.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("c,n_cand,d", [(256, 64, 100), (7, 24, 300)])
def test_cuda_lane_ips_of_a_subset_are_bitwise_the_full_ones(cuda, c,
                                                             n_cand, d):
    """The int8 band re-rank scores (C, 16) rows with the helper the f32
    scan uses at (C, n_cand): on the card each lane's IP must not depend
    on how many rows share the call."""
    rng = np.random.default_rng(c)
    items_t = torch.from_numpy(rng.standard_normal((512, d)).astype(
        np.float32)).to(cuda)
    users = torch.from_numpy(rng.standard_normal((c, d)).astype(
        np.float32)).to(cuda)
    rows = torch.from_numpy(rng.integers(0, 512, (c, n_cand))).to(cuda)
    full = sa_alsh.lane_ips(items_t, rows, users)
    for s in (16, 8):
        pos = torch.argsort(torch.rand(c, n_cand, device=cuda))[:, :s]
        sub = sa_alsh.lane_ips(items_t, rows.gather(1, pos), users)
        assert torch.equal(sub, full.gather(1, pos))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,hkv,dtype,causal,wgmma", [
    ((1, 2, 64, 32), 2, "float32", True, False),
    ((2, 16, 512, 128), 16, "bfloat16", True, True),   # the prefill width
    ((2, 16, 512, 128), 8, "bfloat16", True, True),    # qwen3's 2 q per KV
    ((1, 12, 300, 128), 2, "bfloat16", True, True),    # qwen2-1.5b's 6
    ((1, 3, 300, 128), 3, "bfloat16", True, True),     # ragged S
    ((2, 2, 300, 64), 1, "float32", True, False),
    ((2, 4, 200, 128), 4, "bfloat16", False, True),    # non-causal, ragged
    ((2, 4, 200, 64), 2, "bfloat16", False, True),     # Dh 64, non-causal
    ((1, 2, 130, 96), 2, "float32", False, False),
    ((1, 2, 77, 40), 2, "bfloat16", True, True),       # Dh % 8 == 0: TMA,
                                                       # padded to 64
    ((1, 2, 77, 36), 1, "bfloat16", True, False),      # Dh % 8 != 0: mma
    ((3, 1, 1, 8), 1, "bfloat16", True, True),         # one position
    ((2, 4, 1, 128), 2, "bfloat16", True, True),       # S = 1
    ((2, 4, 129, 128), 1, "bfloat16", True, True)])    # one row past a tile
def test_cuda_flash_attention_matches_plain(cuda, shape, hkv, dtype, causal,
                                            wgmma):
    assert not torch.backends.cuda.matmul.allow_tf32
    b, h, s, d = shape
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)).to(cuda)
               for a in _qkv(s + d, shape))
    k, v = k[:, :hkv].contiguous(), v[:, :hkv].contiguous()
    before = dict(ops.launch_counts)
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.launch_counts["flash_attention"] == \
        before["flash_attention"] + 1
    assert ops.launch_counts["flash_attention_wgmma"] == \
        before["flash_attention_wgmma"] + int(wgmma)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = ref.flash_attention(q, k, v, causal=causal).float()
    err = (got.float() - want).abs()
    if dtype == "float32":
        assert float(err.max()) <= 5e-5
    else:
        assert bool((err <= 2.0 ** -6 * want.abs() + 1e-3).all()), \
            float(err.max())


@pytest.mark.gpu
def test_cuda_flash_attention_unaligned_takes_mma(cuda):
    """A bf16 view 2 bytes past an aligned base takes mma.sync, right."""
    q, k, v = (torch.from_numpy(a).bfloat16().to(cuda)
               for a in _qkv(3, (1, 2, 70, 64)))
    buf = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=cuda)
    qu = buf[1:1 + q.numel()].view(q.shape)
    qu.copy_(q)
    assert flash_attention.route(qu, k, v) == "mma"
    before = ops.launch_counts["flash_attention_wgmma"]
    got = ops.flash_attention(qu, k, v)
    torch.cuda.synchronize()
    assert ops.launch_counts["flash_attention_wgmma"] == before
    want = ref.flash_attention(q, k, v).float()
    assert bool(((got.float() - want).abs()
                 <= 2.0 ** -6 * want.abs() + 1e-3).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_flash_attention_refuses_grad(cuda, dtype):
    """The CUDA kernel has no backward (nor has the reference's Pallas
    kernel): under grad it raises instead of returning an output cut off
    from the graph, and launches nothing; under no_grad it runs."""
    q, k, v = (torch.from_numpy(a).to(getattr(torch, dtype)).to(cuda)
               for a in _qkv(6, (1, 2, 64, 64)))
    before = dict(ops.launch_counts)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(True), k, v)
    assert ops.launch_counts == before
    with torch.no_grad():
        out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert out.shape == q.shape and not out.requires_grad


def _refuse_hamming_srp(cuda):
    codes = torch.zeros(4, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        hamming_scan.hamming_scores(codes[:, ::2], codes[:, ::2])
    with pytest.raises(ValueError, match="widths differ"):
        hamming_scan.hamming_scores(codes, codes[:, :4].contiguous())
    with pytest.raises(ValueError, match="multiple of 32"):
        srp_hash.srp_hash(torch.zeros(2, 4, device=cuda),
                          torch.zeros(4, 48, device=cuda))
    mask = torch.ones(4097, dtype=torch.bool, device=cuda)
    codes = torch.zeros(4097, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="tile must have 1 to 4096 rows"):
        hamming_scan.hamming_nearest(codes[:2], codes, mask, 3)
    with pytest.raises(ValueError, match="n_cand must be in"):
        hamming_scan.hamming_nearest(codes[:2], codes[:8], mask[:8], 9)
    wide = torch.zeros(8, 33, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="code width must be in"):
        hamming_scan.hamming_nearest(wide[:2], wide, mask[:8], 3)


def _refuse_fused_ip_topk(cuda):
    args = list(_torch_fused(_fused_inputs(1, 4, 16, 2, 5), cuda))
    with pytest.raises(ValueError, match="n_cand must be in"):
        fused_scan.fused_scan(*args, n_cand=17)
    args[3] = args[3].to(torch.int32)
    with pytest.raises(ValueError, match="qitems must be 2-D torch.int8"):
        fused_scan.fused_scan(*args, n_cand=3)
    args = list(_torch_fused(_fused_inputs(1, 4, 4097, 2, 5), cuda))
    with pytest.raises(ValueError, match="tile must have 1 to 4096 rows"):
        fused_scan.fused_scan(*args, n_cand=3)
    x = torch.zeros(4, 8, device=cuda)
    with pytest.raises(ValueError, match="k must be in"):
        ip_topk.ip_topk_tiles(x, x, 5)
    big = torch.zeros(200, 8, device=cuda)
    with pytest.raises(ValueError, match="k must be in"):
        ip_topk.ip_topk_tiles(x, big, 129)


def _refuse_flash(cuda):
    x = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="bf16 or float32"):
        flash_attention.flash_attention(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="k must be 4-D torch.float32"):
        flash_attention.flash_attention(x, x.bfloat16(), x)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention.flash_attention(x.transpose(1, 2), x, x)
    with pytest.raises(ValueError, match="one shape"):
        flash_attention.flash_attention(x, x[:, :, :4].contiguous(), x)
    with pytest.raises(ValueError, match="B, S and Dh"):
        flash_attention.flash_attention(x, x[:, :, :4].contiguous(),
                                        x[:, :, :4].contiguous())
    x4 = torch.zeros(1, 4, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="not a multiple"):
        flash_attention.flash_attention(x4, x4[:, :3].contiguous(),
                                        x4[:, :3].contiguous())
    big = torch.zeros(1, 1, 4, 160, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(big, big, big)


@pytest.mark.gpu
@pytest.mark.parametrize("check", [_refuse_hamming_srp, _refuse_fused_ip_topk,
                                   _refuse_flash],
                         ids=["hamming_srp", "fused_ip_topk", "flash"])
def test_cuda_wrappers_refuse_bad_inputs(cuda, check):
    check(cuda)


@pytest.mark.gpu
def test_cuda_engine_refuses_a_tile_past_the_kernel_limit(cuda):
    """A CUDA engine whose sketch-scan tile is past the selection's 4,096
    rows raises when it is made, naming the kernel; the CPU takes it."""
    from repro_torch import RkMIPSEngine, get_config
    with pytest.raises(ValueError, match="hamming_nearest.*4096 rows"):
        RkMIPSEngine(get_config("sah").replace(tile=8192), device=cuda)
    with pytest.raises(ValueError, match="fused_scan.*1024 bits"):
        RkMIPSEngine(get_config("sah").replace(n_bits=2048,
                                               scan_precision="int8"),
                     device=cuda)
    RkMIPSEngine(get_config("sah").replace(tile=4096), device=cuda)
    RkMIPSEngine(get_config("sah").replace(tile=8192), device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-1.5b", "olmoe-1b-7b",
                                  "dbrx-132b", "mistral-nemo-12b"])
def test_cuda_lm_flash_prefill_matches_cpu_chunked(cuda, arch):
    """The smoke LM on the card through the kernel (float32) against the
    same weights on the CPU through plain chunked attention."""
    from repro_torch.configs import base
    from repro_torch.models import transformer as tf
    cfg = base.get(arch).make_smoke_config()
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 48))).long()
    want, cache_want = tf.prefill(model, toks)
    model.cfg = dataclasses.replace(cfg, attn_impl="flash")
    model.to(cuda)
    before = ops.launch_counts["flash_attention"]
    got, cache = tf.prefill(model, toks.to(cuda))
    step, _ = tf.decode_step(model, cache, toks[:, 0].to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts["flash_attention"] == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    step_want, _ = tf.decode_step(model.to("cpu"), cache_want, toks[:, 0])
    np.testing.assert_allclose(step.cpu().numpy(), step_want.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_scan_kernels_equal_plain_on_a_tile_with_deleted_rows(cuda):
    """An artifact's deletions mask rows inside tiles: on the first tile
    of the delete view that holds a deleted row, ``hamming_nearest`` and
    ``fused_scan`` equal their plain versions, and the int8 delta path
    predicts as the f32 one."""
    from repro_torch import RkMIPSEngine, get_config
    from repro_torch.engine import IndexArtifact
    rng = np.random.default_rng(14)
    items = np.abs(rng.standard_normal((3000, 100))).astype(np.float32)
    users = np.abs(rng.standard_normal((4000, 100))).astype(np.float32)
    cfg = get_config("sah").replace(k_max=10, tile=512)
    art = IndexArtifact.build(items, users, torch.Generator().manual_seed(0),
                              config=cfg, device=cuda)
    changed = art.delete_items(np.arange(150, 3000, 7)).insert_items(
        items[:40] * 1.01)
    view = changed.query_view()[0]
    interior = view.alsh.item_mask != art.index.alsh.item_mask
    t = int(torch.nonzero(interior)[0]) // cfg.tile
    sl = slice(t * cfg.tile, (t + 1) * cfg.tile)
    a = view.alsh
    users_c = view.users[:256].contiguous()
    ucodes = ops.srp_hash(users_c, a.proj[:-1])
    args = (ucodes, a.codes[sl], a.item_mask[sl], 64)
    assert not bool(a.item_mask[sl].all())
    assert torch.equal(ops.hamming_nearest(*args),
                       ref.hamming_nearest(*args))
    fargs = (ucodes, a.codes[sl], a.item_mask[sl], a.qitems[sl],
             a.qscale[sl], users_c)
    for got, want in zip(ops.fused_scan(*fargs, n_cand=64),
                         ref.fused_scan(*fargs, 64)):
        assert torch.equal(got, want)
    q = items[np.argsort(-np.linalg.norm(items, axis=1))[:3]]
    f32 = RkMIPSEngine.from_artifact(changed).query_batch(q, 10)
    int8 = RkMIPSEngine(cfg.replace(scan_precision="int8")).attach(
        changed).query_batch(q, 10)
    assert torch.equal(f32.predictions, int8.predictions)


def test_build_load_from_two_threads_builds_once(monkeypatch, tmp_path):
    """Two threads that first use one kernel together get one library: one
    nvcc run and one load (``_build.load`` holds a lock), each build
    writing a temporary file of its own. nvcc and ``ctypes.CDLL`` are
    stubbed; the stub nvcc sleeps so both threads are inside ``load``."""
    import ctypes
    import subprocess
    import threading
    import time
    from repro_torch.kernels import _build

    runs, outs, loads = [], [], []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            runs.append(cmd)
            out = cmd[cmd.index("-o") + 1]
            outs.append(out)
            time.sleep(0.2)
            with open(out, "w") as f:
                f.write("lib")
            self.returncode = 0

        def communicate(self):
            return "ptxas info: Used 1 registers", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(ctypes, "CDLL",
                        lambda path: loads.append(path) or object())
    got, errors = [], []

    def use():
        try:
            got.append(_build.load("hamming_scan"))
        except BaseException as e:  # noqa: BLE001 -- reported below
            errors.append(e)

    threads = [threading.Thread(target=use) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors and len(got) == 2 and got[0] is got[1]
    assert len(runs) == 1 and len(loads) == 1
    assert loads[0] == str(_build._target("hamming_scan"))
    assert (tmp_path / _build._target("hamming_scan").name).exists()
    # two builds started together never share a temporary file
    _, tmp_a, _ = _build._start("srp_hash")
    _, tmp_b, _ = _build._start("srp_hash")
    assert tmp_a != tmp_b and tmp_a.parent == tmp_path


def test_launch_counts_add_up_under_threads():
    """``count_launch`` from many threads loses no launch."""
    import threading
    from repro_torch.kernels import _build

    before = _build.launch_counts["ip_topk"]

    def bump():
        for _ in range(2000):
            _build.count_launch("ip_topk")

    threads = [threading.Thread(target=bump) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert _build.launch_counts["ip_topk"] - before == 16000


@pytest.mark.gpu
def test_cuda_flat_scan_rows_do_not_depend_on_the_batch(cuda):
    """The serving scan on the card (one dense ``hamming_scores`` launch,
    ``ref.nearest_rows``, the ``lane_ips`` re-rank): a query's ids and
    values are bitwise the same in batches of 1, 2, 4 and 8, under both
    scans, as the bucket ladder needs."""
    from repro_torch.engine import sharding
    g = torch.Generator().manual_seed(3)
    items = torch.randn(4000, 100, generator=g)
    idx = sa_alsh.build_index(items.to(cuda), g, n_bits=128, tile=512)
    q = torch.randn(8, 100, generator=g).to(cuda)
    for scan in ("sketch", "exact"):
        def run(rows):
            uc = sa_alsh.user_codes(idx, rows) if scan == "sketch" else None
            return sharding.kmips_flat_arrays(
                idx.items, idx.item_ids, idx.item_mask, idx.codes, uc, rows,
                10, n_cand=64, scan=scan)
        full = run(q)
        for b in (1, 2, 4):
            for lo in range(0, 8, b):
                vals, ids = run(q[lo:lo + b].contiguous())
                assert torch.equal(ids, full[1][lo:lo + b])
                assert torch.equal(vals, full[0][lo:lo + b])

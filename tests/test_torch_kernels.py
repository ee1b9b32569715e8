"""Kernel layer of the PyTorch port (``repro_torch.kernels``) held against
the JAX reference (``repro.kernels``).

On the CPU the plain PyTorch versions run: Hamming distances must equal
the reference's ``ref.hamming_scores`` and its Pallas kernel in interpret
mode exactly; SRP codes must equal the reference bit for bit except for
flips whose float64 score lies within ``8 * d * 2**-24 * sum_i |x_i p_i|``
of 0 (the two sum in different orders). Codes travel as int32 bit views
and are compared through ``.view(np.uint32)``.

Tests marked ``gpu`` hold each CUDA kernel against its plain version and
skip where no CUDA device is present (decided in a fixture, so every
worker collects the same tests). They need no JAX: the reference is
imported by the ``jx`` fixture, so this file also runs where only the
port is installed (``pytest -m gpu tests/test_torch_kernels.py``).
"""

import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import hamming_scan, ops, ref, srp_hash


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def jx():
    """The JAX reference's kernel modules."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import hamming_scan as jax_hamming
    from repro.kernels import ref as jax_ref
    from repro.kernels import srp_hash as jax_srp
    return types.SimpleNamespace(jnp=jnp, hamming=jax_hamming, ref=jax_ref,
                                 srp=jax_srp)


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


def test_ops_dispatch_by_device():
    rng = np.random.default_rng(1)
    q, n = _t(_u32(rng, (4, 4))), _t(_u32(rng, (9, 4)))
    before = dict(ops.launch_counts)
    assert torch.equal(ops.hamming_scores(q, n), ref.hamming_scores(q, n))
    x, p = torch.randn(3, 5), torch.randn(5, 64)
    assert torch.equal(ops.srp_hash(x, p), ref.srp_hash(x, p))
    assert ops.launch_counts == before          # the plain path launches none
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.hamming_scores(q.to("meta"), n.to("meta"))


def test_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers never fall back to the plain version."""
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        hamming_scan.hamming_scores(torch.zeros(2, 4, dtype=torch.int32),
                                    torch.zeros(3, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        srp_hash.srp_hash(torch.zeros(2, 4), torch.zeros(4, 32))


def test_reset_launch_counts():
    ops.launch_counts["srp_hash"] += 3
    ops.reset_launch_counts()
    assert set(ops.launch_counts.values()) == {0}


@pytest.mark.gpu
@pytest.mark.parametrize("nq,n,w", [(256, 512, 4), (1, 1, 1), (33, 77, 3),
                                    (8, 4096, 8)])
def test_cuda_hamming_equals_plain(cuda, nq, n, w):
    rng = np.random.default_rng(nq + n)
    q, it = _t(_u32(rng, (nq, w))).to(cuda), _t(_u32(rng, (n, w))).to(cuda)
    before = ops.launch_counts["hamming_scores"]
    got = ops.hamming_scores(q, it)
    torch.cuda.synchronize()
    assert ops.launch_counts["hamming_scores"] == before + 1
    assert torch.equal(got.cpu(), ref.hamming_scores(q.cpu(), it.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,b", [(256, 100, 128), (17920, 101, 128),
                                   (5, 3, 32), (64, 700, 1024)])
def test_cuda_srp_equals_plain_up_to_rounding_flips(cuda, n, d, b):
    rng = np.random.default_rng(n + d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    proj = rng.standard_normal((d, b)).astype(np.float32)
    got = ops.srp_hash(torch.from_numpy(x).to(cuda),
                       torch.from_numpy(proj).to(cuda))
    torch.cuda.synchronize()
    want = ref.srp_hash(torch.from_numpy(x), torch.from_numpy(proj))
    _flip_bound_check(x, proj, got.cpu().numpy().view(np.uint32),
                      want.numpy().view(np.uint32))


@pytest.mark.gpu
def test_cuda_wrappers_refuse_bad_inputs(cuda):
    codes = torch.zeros(4, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        hamming_scan.hamming_scores(codes[:, ::2], codes[:, ::2])
    with pytest.raises(ValueError, match="widths differ"):
        hamming_scan.hamming_scores(codes, codes[:, :4].contiguous())
    with pytest.raises(ValueError, match="multiple of 32"):
        srp_hash.srp_hash(torch.zeros(2, 4, device=cuda),
                          torch.zeros(4, 48, device=cuda))

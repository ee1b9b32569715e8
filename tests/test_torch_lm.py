"""The LM serving path of the PyTorch port (``repro_torch.models``,
``repro_torch.configs``), dense and MoE, held against the JAX reference on
the CPU.

Inputs are made with numpy from a seed; the weights are the reference's
own ``init_params`` arrays, copied into the port by
``models/convert.params_from_jax`` (bitwise). Tolerances, with reasons:

- float32 (the smoke configs): rtol 1e-4, atol 1e-4. XLA and PyTorch sum
  the products and norms in different orders; through two layers the two
  differ by ~2e-6 on values of order 1 (measured at these shapes).
- attention alone, float32: atol 5e-5, as the reference's own flash tests
  (``tests/test_kernels.py``).
- bf16 (qwen3-smoke and olmoe-smoke in bf16): rtol 2^-5, atol 2^-4. The
  two frameworks round to bf16 at different points (XLA may keep float32
  between fused ops); the results differ by up to 2 bf16 ulps (0.03 on
  values near 3). The MoE router is float32 on both sides.
- Greedy tokens are equal except where the reference's two largest logits
  lie within that tolerance of each other (a traced near-tie).

The reference reaches its Pallas flash kernel, in interpret mode, with
``REPRO_FORCE_INTERPRET=1``, as its own tests do.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import transformer as jtf

from repro_torch.configs import base
from repro_torch.models import attention, convert
from repro_torch.models import transformer as tf

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2.0 ** -5, atol=2.0 ** -4)
N_DECODE = 3


def _np(x):
    """A JAX or torch array as float32 numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _configs(arch, **kw):
    """The reference's and the port's smoke config of ``arch`` with the
    same changes; ``dtype`` is given by name."""
    dtype = kw.pop("dtype", None)
    jcfg = dataclasses.replace(jbase.get(arch).make_smoke_config(), **kw)
    cfg = dataclasses.replace(base.get(arch).make_smoke_config(), **kw)
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=getattr(jnp, dtype))
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    return jcfg, cfg


def _models(jcfg, cfg, seed=0):
    params = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    return params, convert.params_from_jax(
        jax.tree.map(np.asarray, params), cfg, "cpu")


def _tokens(rng, vocab, shape):
    return rng.integers(0, vocab, shape).astype(np.int32)


# ---- attention ------------------------------------------------------------

@pytest.mark.parametrize("n_rep", [1, 2, 3])
def test_repeat_kv_is_exact(n_rep):
    x = np.random.default_rng(n_rep).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    got = attention.repeat_kv(torch.from_numpy(x), n_rep).numpy()
    np.testing.assert_array_equal(got, np.asarray(jattn.repeat_kv(
        jnp.asarray(x), n_rep)))
    for h in range(3 * n_rep):              # head h reads KV head h // n_rep
        np.testing.assert_array_equal(got[:, h], x[:, h // n_rep])


@pytest.mark.parametrize("sq,skv,chunk,causal", [
    (16, 16, 8, True), (16, 16, 16, False), (8, 20, 8, True),
    (20, 20, 8, True), (12, 12, 5, False)])
def test_chunked_and_naive_attention_match_reference(sq, skv, chunk,
                                                     causal):
    rng = np.random.default_rng(sq * skv + chunk)
    q = rng.standard_normal((2, 3, sq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 3, skv, 16)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    np.testing.assert_allclose(
        attention.chunked_attention(tq, tk, tv, chunk=chunk,
                                    causal=causal).numpy(),
        np.asarray(jattn.chunked_attention(jq, jk, jv, chunk=chunk,
                                           causal=causal)), atol=5e-5)
    np.testing.assert_allclose(
        attention.naive_attention(tq, tk, tv, causal=causal).numpy(),
        np.asarray(jattn.naive_attention(jq, jk, jv, causal=causal)),
        atol=5e-5)


@pytest.mark.parametrize("length", [1, 7, 24])
def test_decode_attention_matches_reference(length):
    rng = np.random.default_rng(length)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 4, 24, 16)).astype(np.float32)
              for _ in range(2))
    got = attention.decode_attention(torch.from_numpy(q),
                                     torch.from_numpy(kc),
                                     torch.from_numpy(vc), length)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(length))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


# ---- configs and parameters -----------------------------------------------

def test_lm_config_fields_diff_only_by_the_dropped_jit_knobs():
    ref = [f.name for f in dataclasses.fields(jtf.LMConfig)]
    port = [f.name for f in dataclasses.fields(tf.LMConfig)]
    # scan_layers chooses how JAX traces the layer stack, which eager
    # PyTorch does not; remat is kept (torch.utils.checkpoint, PORT.md)
    assert [n for n in ref if n != "scan_layers"] == port
    for f in dataclasses.fields(tf.LMConfig):
        if f.name != "dtype":
            assert f.default == jtf.LMConfig.__dataclass_fields__[
                f.name].default, f.name


LM_ARCHS = ["dbrx-132b", "mistral-nemo-12b", "olmoe-1b-7b", "qwen2-1.5b",
            "qwen3-0.6b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_arch_configs_are_the_references(arch):
    assert base.all_archs() == jbase.all_archs() == [
        "dbrx-132b", "deepfm", "din", "gat-cora", "mistral-nemo-12b",
        "olmoe-1b-7b", "qwen2-1.5b", "qwen3-0.6b", "two-tower-retrieval",
        "xdeepfm"]
    spec, jspec = base.get(arch), jbase.get(arch)
    assert ([dataclasses.asdict(s) for s in spec.shapes]
            == [dataclasses.asdict(s) for s in jspec.shapes])
    for f in ("family", "source", "notes", "tp_heads", "pure_dp_train",
              "train_grad_accum"):
        assert getattr(spec, f) == getattr(jspec, f), f
    for make in ("make_config", "make_smoke_config"):
        cfg, jcfg = getattr(spec, make)(), getattr(jspec, make)()
        for f in dataclasses.fields(cfg):
            want = getattr(jcfg, f.name)
            got = getattr(cfg, f.name)
            if f.name == "dtype":
                assert str(got).removeprefix("torch.") == jnp.dtype(
                    want).name
            elif f.name == "moe" and want is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, (make, f.name)
        assert cfg.n_params == jcfg.n_params
        assert cfg.n_active_params == jcfg.n_active_params
        assert cfg.head_dim == jcfg.head_dim


def test_n_params_is_the_references_and_counts_the_weights():
    full = base.get("qwen3-0.6b").make_config()
    assert full.n_params == jbase.get("qwen3-0.6b").make_config().n_params
    assert full.n_active_params == full.n_params
    assert (full.n_layers, full.d_model, full.vocab) == (28, 1024, 151936)
    # the sizes the port runs at full width on one card, and dbrx's
    for arch, billions in (("olmoe-1b-7b", 6.92), ("dbrx-132b", 131.60),
                           ("mistral-nemo-12b", 12.25)):
        assert round(base.get(arch).make_config().n_params / 1e9,
                     2) == billions
    for arch in LM_ARCHS:
        cfg = base.get(arch).make_smoke_config()
        model = tf.LM(cfg, device="meta")
        numel = sum(p.numel() for p in model.parameters())
        # the reference's count leaves out the qk-norm scales and the QKV
        # biases; every other parameter is counted once
        extra = sum(p.numel() for n, p in model.named_parameters()
                    if n.split(".")[-1] in ("q_norm", "k_norm", "bq", "bk",
                                            "bv"))
        assert cfg.n_params == numel - extra
        assert (extra > 0) == (cfg.qk_norm or cfg.qkv_bias)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_is_bitwise(dtype):
    jcfg, cfg = _configs("qwen3-0.6b", dtype=dtype)
    params, model = _models(jcfg, cfg, seed=3)
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    port = dict(model.named_parameters())
    leaves = {n: params[n] for n in ("embed", "head", "final_norm")}
    for n, stacked in params["layers"].items():
        leaves.update({f"blocks.{i}.{n}": stacked[i]
                       for i in range(cfg.n_layers)})
    assert set(leaves) == set(port)
    for name, leaf in leaves.items():
        p = port[name]
        assert str(p.dtype).removeprefix("torch.") == dtype
        want = np.asarray(leaf).view(bits)
        got = p.view(torch.int16 if bits is np.uint16 else torch.int32)
        np.testing.assert_array_equal(got.numpy().view(bits), want, name)


def test_params_from_jax_refuses_a_mismatched_tree():
    jcfg, cfg = _configs("qwen3-0.6b")
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    with pytest.raises(ValueError, match="q_norm"):
        convert.params_from_jax(
            tree, dataclasses.replace(cfg, qk_norm=False), "cpu")
    bad = dict(tree, embed=tree["embed"][:, :-1])
    with pytest.raises(ValueError, match="embed"):
        convert.params_from_jax(bad, cfg, "cpu")


def test_init_params_draws_at_the_references_scales():
    cfg = dataclasses.replace(base.get("qwen2-1.5b").make_smoke_config(),
                              vocab=4096)
    model = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    d, f, nhd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    blk = model.blocks[1]
    for p, scale in ((blk.wq, d ** -0.5), (blk.wo, nhd ** -0.5),
                     (blk.w_out, f ** -0.5), (model.embed, 1.0),
                     (model.head, d ** -0.5)):
        assert abs(float(p.std()) / scale - 1) < 0.05
    assert bool((blk.ln1 == 1).all()) and bool((blk.bq == 0).all())
    assert bool((model.final_norm == 1).all())
    again = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again.blocks[0].wk, model.blocks[0].wk)


def test_lm_config_refuses_moe_and_unknown_attention():
    """``moe`` takes a ``MoEConfig`` (or None) and nothing else."""
    cfg = base.get("qwen3-0.6b").make_smoke_config()
    with pytest.raises(TypeError, match="moe"):
        dataclasses.replace(cfg, moe=object())
    moe_cfg = base.get("olmoe-1b-7b").make_smoke_config().moe
    assert dataclasses.replace(cfg, moe=moe_cfg).moe is moe_cfg
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(cfg, attn_impl="paged")


# ---- the whole slice: forward, prefill, decode ----------------------------

def _check_greedy(ref_logits, port_logits, tol):
    """Port argmax == reference argmax, except where the reference's top
    two logits lie within ``tol`` of each other. Returns the near-ties."""
    want = ref_logits.argmax(-1)
    got = port_logits.argmax(-1)
    top2 = np.sort(ref_logits, axis=-1)[:, -2:]
    near = (top2[:, 1] - top2[:, 0]) <= tol["atol"] + tol["rtol"] * np.abs(
        top2[:, 1])
    assert np.all((got == want) | near), (got, want)
    return int(np.sum(got != want))


def _run_slice(jcfg, cfg, tol, seed):
    params, model = _models(jcfg, cfg, seed)
    rng = np.random.default_rng(seed)
    toks = _tokens(rng, cfg.vocab, (2, 16))
    ttoks = torch.from_numpy(toks).long()

    hidden, aux, _ = jtf.forward(params, jnp.asarray(toks), jcfg)
    hidden_t, aux_t, _ = tf.forward(model, ttoks)
    np.testing.assert_allclose(_np(hidden_t), _np(hidden), **tol)
    if cfg.moe is None:
        assert float(aux_t) == float(aux) == 0.0
    else:                   # the layers' mean load-balance loss, >= 1
        np.testing.assert_allclose(float(aux_t), float(aux), **tol)
        assert float(aux) >= 1.0

    logits, cache = jtf.prefill(params, jnp.asarray(toks), jcfg)
    logits_t, cache_t = tf.prefill(model, ttoks)
    np.testing.assert_allclose(_np(logits_t), _np(logits), **tol)
    for name in ("k", "v"):
        assert cache_t[name].shape == cache[name].shape
        np.testing.assert_allclose(_np(cache_t[name]), _np(cache[name]),
                                   **tol)
    assert cache_t["length"] == int(cache["length"]) == 16
    ties = _check_greedy(_np(logits), _np(logits_t), tol)

    nxt = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    for _ in range(N_DECODE):   # both sides are fed the reference's token
        logits, cache = jtf.decode_step(params, cache, jnp.asarray(nxt),
                                        jcfg)
        logits_t, cache_t = tf.decode_step(model, cache_t,
                                           torch.from_numpy(nxt).long())
        np.testing.assert_allclose(_np(logits_t), _np(logits), **tol)
        ties += _check_greedy(_np(logits), _np(logits_t), tol)
        nxt = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
    assert cache_t["length"] == int(cache["length"]) == 16 + N_DECODE
    np.testing.assert_allclose(_np(cache_t["k"]), _np(cache["k"]), **tol)
    return ties


@pytest.mark.parametrize("arch,impl", [
    ("qwen3-0.6b", "chunked"), ("qwen3-0.6b", "flash"),
    ("qwen2-1.5b", "chunked"), ("qwen2-1.5b", "flash"),
    ("olmoe-1b-7b", "chunked"), ("olmoe-1b-7b", "flash"),
    ("dbrx-132b", "chunked"), ("mistral-nemo-12b", "chunked")])
def test_prefill_and_decode_match_reference(arch, impl, monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_INTERPRET", "1")
    jcfg, cfg = _configs(arch, attn_impl=impl)
    assert _run_slice(jcfg, cfg, F32_TOL, seed=1) == 0


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_prefill_and_decode_match_reference_bf16(impl, monkeypatch):
    monkeypatch.setenv("REPRO_FORCE_INTERPRET", "1")
    jcfg, cfg = _configs("qwen3-0.6b", attn_impl=impl, dtype="bfloat16")
    _run_slice(jcfg, cfg, BF16_TOL, seed=2)


def test_moe_prefill_and_decode_match_reference_bf16(monkeypatch):
    """olmoe-smoke in bf16: the router stays float32 on both sides."""
    monkeypatch.setenv("REPRO_FORCE_INTERPRET", "1")
    jcfg, cfg = _configs("olmoe-1b-7b", dtype="bfloat16")
    _run_slice(jcfg, cfg, BF16_TOL, seed=2)


def test_flash_and_chunked_prefill_agree_in_the_port():
    _, cfg = _configs("qwen3-0.6b")
    model = tf.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    toks = torch.from_numpy(_tokens(np.random.default_rng(4), cfg.vocab,
                                    (3, 40))).long()
    chunked, cache_c = tf.prefill(model, toks)
    model.cfg = dataclasses.replace(cfg, attn_impl="flash")
    flash, cache_f = tf.prefill(model, toks)
    np.testing.assert_allclose(flash.numpy(), chunked.numpy(), **F32_TOL)
    np.testing.assert_allclose(cache_f["k"].numpy(), cache_c["k"].numpy(),
                               **F32_TOL)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-1.5b"])
def test_flash_route_reads_unrepeated_kv(arch, monkeypatch):
    """On the "flash" route each layer hands the kernel k and v with
    n_kv_heads heads (no repeat_kv copy); the output is the repeated-KV
    call's, bit for bit."""
    _, cfg = _configs(arch, attn_impl="flash")
    assert cfg.n_heads > cfg.n_kv_heads
    model = tf.init_params(cfg, torch.Generator().manual_seed(8), "cpu")
    toks = torch.from_numpy(_tokens(np.random.default_rng(8), cfg.vocab,
                                    (2, 12))).long()
    seen = []
    flash = tf.kops.flash_attention

    def spy(q, k, v, *, causal=True):
        seen.append((q.shape[1], k.shape[1], v.shape[1]))
        got = flash(q, k, v, causal=causal)
        rep = q.shape[1] // k.shape[1]
        assert torch.equal(got, flash(q, attention.repeat_kv(k, rep),
                                      attention.repeat_kv(v, rep),
                                      causal=causal))
        return got

    monkeypatch.setattr(tf.kops, "flash_attention", spy)
    tf.prefill(model, toks)
    assert seen == [(cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads)] \
        * cfg.n_layers


def test_decode_continues_prefill():
    """decode_step at position S after a prefill of S tokens gives the
    last logits of a prefill of the S + 1 tokens."""
    _, cfg = _configs("qwen2-1.5b")
    model = tf.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    toks = torch.from_numpy(_tokens(np.random.default_rng(5), cfg.vocab,
                                    (2, 21))).long()
    _, cache = tf.prefill(model, toks[:, :20])
    stepped, cache = tf.decode_step(model, cache, toks[:, 20])
    whole, _ = tf.prefill(model, toks)
    np.testing.assert_allclose(stepped.numpy(), whole.numpy(), **F32_TOL)
    assert cache["length"] == 21


def test_decode_step_raises_on_a_full_cache():
    _, cfg = _configs("qwen3-0.6b", max_seq=8)
    model = tf.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    toks = torch.zeros((1, 7), dtype=torch.long)
    _, cache = tf.prefill(model, toks)
    _, cache = tf.decode_step(model, cache, toks[:, 0])       # fills slot 7
    with pytest.raises(ValueError, match="full"):
        tf.decode_step(model, cache, toks[:, 0])
    assert cache["length"] == 8
    with pytest.raises(ValueError, match="max_seq"):
        tf.prefill(model, torch.zeros((1, 9), dtype=torch.long))


def test_init_cache_and_full_logits_shapes():
    _, cfg = _configs("qwen3-0.6b")
    cache = tf.init_cache(cfg, 3, device="cpu")
    assert cache["k"].shape == (2, 3, 2, 64, 32) and cache["length"] == 0
    model = tf.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    hidden, _, kv = tf.forward(model, torch.zeros((2, 5), dtype=torch.long),
                               return_cache=True)
    assert tf.full_logits(model, hidden).shape == (2, 5, cfg.vocab)
    assert kv[0].shape == (2, 2, 2, 5, 32)

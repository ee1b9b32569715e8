"""The training path of the PyTorch port (``repro_torch.train``,
``lm_loss``, the recsys losses under autograd, ``launch/train.py``) held
against the JAX reference on the CPU.

Inputs are made with numpy from a seed; weights are the reference's own
``init_params`` arrays, copied into the port bitwise
(``models/convert.py``). Tolerances, with reasons:

- ``lm_loss`` in float32: the loss within rtol 1e-5, each gradient within
  1e-5 of its leaf's largest |value| plus 1e-6 of the largest gradient of
  any leaf. XLA and PyTorch add the products and the cross-entropy terms
  in different orders; at these shapes the two differ by ~1.3e-6 relative
  (measured). The second term covers a leaf whose true gradient is zero
  (a bias that shifts every logit of a softmax alike): it holds only the
  rounding noise of terms on the scale of the largest gradients.
- One optimizer step in float32: updates within 1e-6 of the step's
  largest |update| (measured: 4.4e-7, from ``pow``/``rsqrt`` and sums in
  another order), states and parameters within rtol 1e-5, atol 1e-6.
  Adafactor's bfloat16 first moment within one bfloat16 ulp (2^-8
  relative): two float32 values a few ulps apart can round to
  neighbouring bfloat16 values.
- int8 quantization: the int8 codes and scales exactly (one float32
  division, round half to even, on both sides).
- Adafactor and ``error_feedback`` over an LM's layer stacks (the port's
  per-layer leaves against the reference's (L, ...) leaves), each step
  from the reference's state: updates within 1e-6 of the step's largest
  |update|, plus, under Adafactor's bfloat16 momentum (the update is
  -lr times it), one bfloat16 ulp of the update (2^-7 relative: a
  bfloat16 ulp is 2^-8 to 2^-7 of the value); the optimizer state as
  after one step above, its bfloat16 momentum within one ulp (2^-7) plus
  1e-6 of the leaf's largest |momentum| (a momentum that nearly cancels
  to 0 keeps the float32 differences of the update that made it).
- Three train steps of the smoke LM (chain(clip, adamw(1e-3, eps=1e-6))):
  losses and gradient norms within rtol 1e-5; parameters and moments
  within 1e-5 absolute. Adam moves a component by lr * g / (|g| + eps),
  whose sensitivity to g peaks at lr / (4 eps) where |g| = eps; the two
  frameworks' gradients differ by ~1e-9 absolute on near-cancelling
  components, which at the default eps 1e-8 moves a weight by up to
  ~1.5e-5 (measured: one of 65,536 in ``w_gate``) and at eps 1e-6 by at
  most ~1e-7. The optimizers at their default eps are held op for op by
  ``test_optimizer_matches_reference``.
- Recsys loss gradients in float32: as ``lm_loss``'s (the forward's own
  tolerance is 1e-4, ``test_torch_recsys.py``).
- The bf16 checkpoints across packages, and a resumed port run against an
  uninterrupted one: bit for bit.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import base as jbase
from repro.models import recsys as jrec
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer

from repro_torch.configs import base
from repro_torch.data import synthetic
from repro_torch.launch import train as launch_train
from repro_torch.models import convert, recsys
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression as comp
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import (TrainState, Watchdog, init_state,
                                       make_train_step, train_loop)

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
LM = "qwen3-0.6b"


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _close_to_leaf_max(got, want, what):
    """Each leaf of ``got`` within 1e-5 of ``want``'s largest |value| in
    that leaf, plus 1e-6 of the largest in any leaf (module docstring)."""
    paths = [k for k, _ in jckpt._flatten_with_paths(want)]
    pairs = [(_np(g), _np(w)) for g, w in zip(jax.tree.leaves(got),
                                              jax.tree.leaves(want))]
    assert len(pairs) == len(paths) == len(jax.tree.leaves(got))
    top = max(float(np.abs(w).max()) for _, w in pairs if w.size)
    for path, (g, w) in zip(paths, pairs):
        assert g.shape == w.shape, (what, path)
        err = float(np.abs(g - w).max()) if g.size else 0.0
        leaf = float(np.abs(w).max()) if w.size else 0.0
        assert err <= 1e-5 * leaf + 1e-6 * top, (what, path, err)


def _lm_batches(seed, n, b, s, vocab):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def lm():
    """The smoke LM of both packages (float32) and the reference's
    weights as numpy."""
    jcfg = jbase.get(LM).make_smoke_config()
    cfg = base.get(LM).make_smoke_config()
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, jax.tree.map(np.asarray, jparams)


def _lm_pair(arch: str, seed: int = 0):
    """An arch's smoke LM of both packages (float32): the reference's
    config and parameters as numpy, the port's config and model."""
    jcfg = jbase.get(arch).make_smoke_config()
    cfg = base.get(arch).make_smoke_config()
    tree = jax.tree.map(np.asarray, jtf.init_params(
        jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, tree, convert.params_from_jax(tree, cfg, device="cpu")


def _ref_grads_tree(params: dict, grads) -> dict:
    """The port's per-parameter gradients in the reference's nest."""
    grads = dict(zip(params, grads))
    return convert.train_state_to_numpy(
        TrainState(grads, (), torch.zeros((), dtype=torch.int32))).params


# ---- lm_loss --------------------------------------------------------------

@pytest.mark.parametrize("b,s,remat", [(8, 80, "full"), (8, 80, "none"),
                                       (2, 40, "full")])
def test_lm_loss_and_grads_match_reference(lm, b, s, remat):
    """(8, 80): 640 tokens > loss_chunk, so 8 checkpointed batch chunks;
    (2, 40): one chunk."""
    jcfg, cfg, jparams, tree = lm
    batch = _lm_batches(b, 1, b, s, cfg.vocab)[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, _jax_batch(batch), jcfg)))(jparams)
    model = convert.params_from_jax(
        tree, dataclasses.replace(cfg, remat=remat), device="cpu")
    params = dict(model.named_parameters())
    loss = tf.lm_loss(model, _torch_batch(batch))
    assert loss.dtype == torch.float32 and loss.shape == ()
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    _close_to_leaf_max(_ref_grads_tree(params, grads),
                       jax.tree.map(np.asarray, jgrads), "lm grads")


@pytest.mark.parametrize("remat", ["full", "none"])
def test_moe_lm_loss_and_grads_match_reference(remat):
    """olmoe-smoke: the loss with its aux term (weight 0.01), and every
    gradient, the router's and the experts' included; 8 x 80 tokens, so 8
    checkpointed batch chunks."""
    jcfg, cfg, tree, _ = _lm_pair("olmoe-1b-7b", seed=1)
    batch = _lm_batches(11, 1, 8, 80, cfg.vocab)[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(p, _jax_batch(batch), jcfg)))(
            jax.tree.map(jnp.asarray, tree))
    model = convert.params_from_jax(
        tree, dataclasses.replace(cfg, remat=remat), device="cpu")
    params = dict(model.named_parameters())
    loss = tf.lm_loss(model, _torch_batch(batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    got = _ref_grads_tree(params, grads)
    assert set(got["layers"]["moe"]) == {"router", "w_in", "w_gate",
                                         "w_out"}
    _close_to_leaf_max(got, jax.tree.map(np.asarray, jgrads), "moe grads")


def test_remat_full_equals_none(lm):
    """Checkpointing each layer recomputes the same values: the loss and
    every gradient are bit for bit those of the run without it."""
    _, cfg, _, tree = lm
    batch = _torch_batch(_lm_batches(3, 1, 4, 48, cfg.vocab)[0])
    out = []
    for remat in ("full", "none"):
        model = convert.params_from_jax(
            tree, dataclasses.replace(cfg, remat=remat), device="cpu")
        loss = tf.lm_loss(model, batch)
        out.append((loss, torch.autograd.grad(loss,
                                              list(model.parameters()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


def test_lm_remat_is_validated(lm):
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(lm[1], remat="some")


# ---- optimizers -----------------------------------------------------------

OPTIMIZERS = {
    "adamw_schedule_wd": lambda o, c: o.adamw(o.cosine_schedule(0.1, 2, 5),
                                              weight_decay=0.01),
    "adafactor": lambda o, c: o.adafactor(0.05),
    "adafactor_no_momentum": lambda o, c: o.adafactor(0.05, b1=None),
    "sgd": lambda o, c: o.sgd(0.1, momentum=0.5),
    "chain_clip_adamw": lambda o, c: o.chain(o.clip_by_global_norm(0.5),
                                             o.adamw(0.1)),
    "error_feedback": lambda o, c: c.error_feedback(o.adamw(0.1)),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name):
    """Four steps on {"w" (32, 16) (factored by Adafactor), "b" (16,)
    (kept whole)}: every update, then the final state and parameters."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((32, 16)).astype(np.float32),
          "b": rng.standard_normal(16).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(4)]
    jo = OPTIMIZERS[name](jopt, jcomp)
    to = OPTIMIZERS[name](opt_lib, comp)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        jp = jopt.apply_updates(jp, ju)
        opt_lib.apply_updates(tp, tu)
        scale = max(float(np.abs(np.asarray(u)).max()) for u in ju.values())
        for k in ju:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]),
                                       atol=1e-6 * scale, rtol=0)
    for k in tp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6)
    got = dict(ckpt.flatten_with_paths(ts))
    want = dict(jckpt._flatten_with_paths(js))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.dtype == getattr(torch, str(w.dtype)), path
        if g.dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(g), _np(w), rtol=2.0 ** -8,
                                       atol=0, err_msg=path)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-6, err_msg=path)


STACKED_OPTIMIZERS = {
    "adafactor": lambda o, c: o.adafactor(0.05),
    "adafactor_no_momentum": lambda o, c: o.adafactor(0.05, b1=None),
    "error_feedback": lambda o, c: c.error_feedback(o.adamw(0.1)),
}


def _port_leaves(tree: dict, names) -> dict:
    """The port's per-parameter tensors of a reference LM nest: row i of
    ``layers/a/b`` for ``blocks.i.a.b``."""
    out = {}
    for name in names:
        m = opt_lib.LAYER_LEAF.fullmatch(name)
        node = tree["layers"] if m else tree
        for part in (m[2] if m else name).split("."):
            node = node[part]
        out[name] = torch.from_numpy(np.array(node[int(m[1])] if m
                                              else node))
    return out


def _step_close(tp, tu, ts, ju, js, bf16_update: bool):
    """One step's updates and optimizer state, the port's (per-layer, in
    the reference's layout through ``convert``) against the reference's,
    at the tolerances of the module docstring."""
    want = jax.tree.map(np.asarray, ju)
    scale = max(float(np.abs(u).max()) for u in jax.tree.leaves(want))
    got = ckpt.flatten_with_paths(_ref_grads_tree(tp, tu.values()))
    assert len(got) == len(jax.tree.leaves(want))
    for (path, u), w in zip(got, jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(u), w, atol=1e-6 * scale,
                                   rtol=2.0 ** -7 if bf16_update else 0,
                                   err_msg=path)
    step = torch.zeros((), dtype=torch.int32)
    got = ckpt.flatten_with_paths(
        convert.train_state_to_numpy(TrainState(tp, ts, step)).opt_state)
    want = jckpt._flatten_with_paths(jax.tree.map(np.asarray, js))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), path
        if isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16:
            w = _np(w)
            np.testing.assert_allclose(
                _np(g), w, rtol=2.0 ** -7,
                atol=1e-6 * float(np.abs(w).max()), err_msg=path)
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-5,
                                       atol=1e-6, err_msg=path)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
@pytest.mark.parametrize("name", sorted(STACKED_OPTIMIZERS))
def test_optimizer_over_layer_stacks_matches_reference(arch, name):
    """Three steps on an LM's parameters: the port's per-layer leaves
    against the reference's (L, ...) stacks, the port restarted each step
    from the reference's state (``train_state_from_jax``), so that each
    step is held at one step's tolerance. Layer i's gradients are scaled
    by 10**i, so a statistic taken per layer instead of over the stack
    (the update-RMS clip, the factored norm scales, the int8 scale)
    shows."""
    _, cfg, tree, model = _lm_pair(arch)
    rng = np.random.default_rng(5)
    layer_scale = 10.0 ** np.arange(cfg.n_layers)

    def grads_like(t):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), t)
        g["layers"] = jax.tree.map(
            lambda a: a * layer_scale.reshape((-1,) + (1,) * (a.ndim - 1))
            .astype(np.float32), g["layers"])
        return g

    jo = STACKED_OPTIMIZERS[name](jopt, jcomp)
    to = STACKED_OPTIMIZERS[name](opt_lib, comp)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jo.init(jp)
    # jit only saves time; but under jit XLA may turn the quantizer's
    # x / scale into x * (1 / scale) and move a code by one level at a
    # rounding boundary, so error_feedback runs eagerly, op for op
    jupdate = jo.update if name == "error_feedback" else jax.jit(jo.update)
    state = init_state(dict(model.named_parameters()), to)
    for i in range(3):
        convert.train_state_from_jax(jax.tree.map(np.asarray,
                                                  jtrainer.TrainState(
                                                      jp, js, np.int32(i))),
                                     state)
        tp = state.params
        g = grads_like(tree)
        ju, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(_port_leaves(g, tp), state.opt_state, tp)
        _step_close(tp, tu, ts, ju, js, name == "adafactor")
        jp = jopt.apply_updates(jp, ju)
        state = state._replace(opt_state=ts)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b"])
def test_adafactor_train_state_crosses_packages(arch, tmp_path):
    """A reference Adafactor ``TrainState`` (two steps taken) restores into
    the port through ``convert`` bit for bit, and through a checkpoint each
    way; from it, one more step of each package gives the same state."""
    _, cfg, tree, model = _lm_pair(arch, seed=2)
    rng = np.random.default_rng(6)
    jo, to = jopt.adafactor(0.05), opt_lib.adafactor(0.05)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jo.init(jp)
    jupdate = jax.jit(jo.update)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), tree) for _ in range(3)]
    for g in grads[:2]:
        ju, js = jupdate(jax.tree.map(jnp.asarray, g), js, jp)
        jp = jopt.apply_updates(jp, ju)
    jstate = jax.tree.map(np.asarray,
                          jtrainer.TrainState(jp, js, np.int32(2)))
    state = init_state(dict(model.named_parameters()), to)
    convert.train_state_from_jax(jstate, state)
    assert int(state.step) == 2
    if cfg.n_layers > 1:        # a 1-D stack shares its column statistic
        v = state.opt_state["v"]
        assert v["blocks.0.ln1"]["c"] is v["blocks.1.ln1"]["c"]
        assert v["blocks.0.ln1"]["r"].shape == ()
    for (path, a), (_, b) in zip(
            ckpt.flatten_with_paths(convert.train_state_to_numpy(state)),
            jckpt._flatten_with_paths(jstate)):
        assert _np(a).tobytes() == _np(b).tobytes(), path

    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(port_dir, 2, convert.train_state_to_numpy(state))
    jckpt.save(ref_dir, 2, jax.tree.map(jnp.asarray, jstate))
    assert (ckpt.read_manifest(port_dir, 2)["index"]
            == jckpt.read_manifest(ref_dir, 2)["index"])
    from_port, _ = jckpt.restore(port_dir, 2,
                                 jax.tree.map(jnp.asarray, jstate))
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(jstate)):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    fresh = init_state(dict(convert.params_from_jax(
        tree, cfg, device="cpu").named_parameters()), to)
    restored, _ = ckpt.restore(ref_dir, 2,
                               convert.train_state_to_numpy(fresh))
    convert.train_state_from_jax(restored, fresh)
    for (path, a), (_, b) in zip(
            ckpt.flatten_with_paths(convert.train_state_to_numpy(fresh)),
            jckpt._flatten_with_paths(jstate)):
        assert _np(a).tobytes() == _np(b).tobytes(), path

    ju, js = jupdate(jax.tree.map(jnp.asarray, grads[2]), js, jp)
    tu, ts = to.update(_port_leaves(grads[2], fresh.params),
                       fresh.opt_state, fresh.params)
    _step_close(fresh.params, tu, ts, ju, js, bf16_update=True)


def test_quantize_int8_matches_reference_exactly():
    rng = np.random.default_rng(1)
    for x in (rng.standard_normal(1000).astype(np.float32) * 3,
              np.array([1.0, -0.5, 2.5, 127.0, -127.0, 63.5],
                       np.float32),     # exact halves: rounded to even
              np.zeros(5, np.float32)):
        q, s = comp.quantize_int8(torch.from_numpy(x))
        jq, js = jcomp.quantize_int8(jnp.asarray(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert np.float32(s) == np.asarray(js)
        np.testing.assert_array_equal(comp.dequantize_int8(q, s).numpy(),
                                      np.asarray(jcomp.dequantize_int8(jq,
                                                                       js)))


# ---- the reference's own contracts (tests/test_train.py) ------------------

def _quadratic_problem():
    target = torch.tensor([1.0, -2.0, 3.0])

    def loss(params, batch):
        del batch
        return torch.sum((params["w"] - target) ** 2)

    return loss, {"w": torch.zeros(3)}, target


@pytest.mark.parametrize("make_opt", [
    lambda: opt_lib.adamw(0.1),
    lambda: opt_lib.sgd(0.1, momentum=0.5),
    lambda: opt_lib.adafactor(0.5),
    lambda: opt_lib.chain(opt_lib.clip_by_global_norm(1.0),
                          opt_lib.adamw(0.1)),
    lambda: comp.error_feedback(opt_lib.adamw(0.1)),
])
def test_optimizers_converge(make_opt):
    loss, params, target = _quadratic_problem()
    opt = make_opt()
    step = make_train_step(loss, opt)
    state = init_state(params, opt)
    for _ in range(300):
        state, _ = step(state, None)
    np.testing.assert_allclose(state.params["w"].detach().numpy(),
                               target.numpy(), atol=0.05)


def test_adamw_first_step_is_lr_sized():
    opt = opt_lib.adamw(0.1)
    params = {"w": torch.tensor([1.0])}
    updates, _ = opt.update({"w": torch.tensor([0.5])}, opt.init(params),
                            params)
    # bias-corrected first step = -lr * g/|g| = -0.1
    np.testing.assert_allclose(updates["w"].numpy(), [-0.1], rtol=1e-4)


def test_adafactor_state_is_factored():
    st = opt_lib.adafactor(0.1).init({"w": torch.zeros(32, 16),
                                      "b": torch.zeros(16)})
    assert st["v"]["w"]["r"].shape == (32,)
    assert st["v"]["w"]["c"].shape == (16,)
    assert st["v"]["b"]["full"].shape == (16,)
    assert st["m"]["w"].dtype == torch.bfloat16


def test_grad_accum_matches_full_batch():
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(4, 4, generator=gen)
    batch = {"x": torch.randn(8, 4, generator=gen),
             "y": torch.randn(8, 4, generator=gen)}

    def loss(params, b):
        return torch.mean((b["x"] @ params["w"] - b["y"]) ** 2)

    opt = opt_lib.sgd(0.1, momentum=0.0)
    out = []
    for accum in (1, 4):
        params = {"w": w.clone()}
        state, metrics = make_train_step(loss, opt, grad_accum=accum)(
            init_state(params, opt), batch)
        out.append((state.params["w"].detach(), metrics))
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(),
                               rtol=1e-5)
    np.testing.assert_allclose(float(out[0][1]["loss"]),
                               float(out[1][1]["loss"]), rtol=1e-5)
    assert int(out[1][1]["step"]) == 1


def test_failure_recovery_resumes_identically(tmp_path):
    """Train 10 steps with a crash at step 6 + restart == uninterrupted."""
    loss, _, _ = _quadratic_problem()
    opt = opt_lib.adamw(0.05)
    step = make_train_step(loss, opt)

    def data():
        while True:
            yield None

    def fresh():
        params = {"w": torch.zeros(3)}
        return init_state(params, opt)

    quiet = dict(log_every=100, log_fn=lambda s: None)
    ref = train_loop(fresh(), step, data(), n_steps=10, **quiet)
    cdir = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="simulated"):
        train_loop(fresh(), step, data(), n_steps=10, ckpt_dir=cdir,
                   ckpt_every=2, fail_at_step=6, **quiet)
    last = ckpt.latest_step(cdir)
    assert last == 6
    state = fresh()
    tree, _ = ckpt.restore(cdir, last, convert.train_state_to_numpy(state))
    state = convert.train_state_from_jax(tree, state)
    assert int(state.step) == 6
    resumed = train_loop(state, step, data(), n_steps=10, **quiet)
    assert torch.equal(resumed.params["w"], ref.params["w"])


def test_int8_quantization_error_bound():
    x = torch.randn(256, generator=torch.Generator().manual_seed(0)) * 3.0
    q, s = comp.quantize_int8(x)
    err = (comp.dequantize_int8(q, s) - x).abs().max()
    assert float(err) <= float(s) / 2 + 1e-6


def test_error_feedback_preserves_signal():
    """With EF, repeated identical gradients lose no mass: the mean of the
    compressed updates converges to the true gradient."""
    opt = comp.error_feedback(opt_lib.sgd(1.0, momentum=0.0))
    params = {"w": torch.zeros(4)}
    st = opt.init(params)
    g = {"w": torch.tensor([1e-4, 1.0, -0.5, 2.0])}
    total = torch.zeros(4)
    for _ in range(50):
        upd, st = opt.update(g, st, params)
        total = total + upd["w"]
    np.testing.assert_allclose((-total / 50).numpy(), g["w"].numpy(),
                               rtol=0.02, atol=1e-4)


def test_watchdog_flags_stragglers():
    wd = Watchdog(threshold=3.0)
    for _ in range(10):
        assert not wd.observe(0.1)
    assert wd.observe(1.0)
    assert wd.slow_steps == 1


def test_checkpoint_roundtrip_nested_and_bf16(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.asarray([1, 2], np.int32)},
            "d": torch.tensor(3.5, dtype=torch.bfloat16),
            "e": [torch.randn(2, 2).bfloat16(), ()]}
    ckpt.save(str(tmp_path), 7, tree, {"note": "x"})
    restored, meta = ckpt.restore(str(tmp_path), 7, tree)
    assert meta["note"] == "x"
    for (k, a), (k2, b) in zip(ckpt.flatten_with_paths(tree),
                               ckpt.flatten_with_paths(restored)):
        assert k == k2
        if isinstance(a, torch.Tensor):
            assert b.dtype == torch.bfloat16 and torch.equal(a, b)
        else:
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 7, {**tree, "a": np.zeros((3, 2))})


# ---- the train step against the reference's ---------------------------

@pytest.mark.parametrize("grad_accum", [1, 4])
def test_train_step_trajectory_matches_reference(lm, grad_accum):
    """Three steps of chain(clip_by_global_norm(1.0), adamw(1e-3,
    eps=1e-6)) on the smoke LM, batches of 8 x 80 tokens, from the same
    weights: each step's loss and gradient norm, then the parameters and
    the optimizer state (eps: module docstring)."""
    jcfg, cfg, jparams, tree = lm
    batches = _lm_batches(7, 3, 8, 80, cfg.vocab)

    def make(o):
        return o.chain(o.clip_by_global_norm(1.0), o.adamw(1e-3, eps=1e-6))

    jo = make(jopt)
    jstep = jax.jit(jtrainer.make_train_step(
        lambda p, b: jtf.lm_loss(p, b, jcfg), jo, grad_accum=grad_accum))
    jstate = jtrainer.TrainState(jparams, jo.init(jparams),
                                 jnp.zeros((), jnp.int32))
    model = convert.params_from_jax(tree, cfg, device="cpu")
    to = make(opt_lib)
    step = make_train_step(lambda p, b: tf.lm_loss(model, b), to,
                           grad_accum=grad_accum)
    state = init_state(dict(model.named_parameters()), to)
    for batch in batches:
        jstate, jm = jstep(jstate, _jax_batch(batch))
        state, m = step(state, _torch_batch(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
        assert int(m["step"]) == int(jm["step"])
    got = convert.train_state_to_numpy(state)
    want = jax.tree.map(np.asarray, jstate)
    for (path, g), (path2, w) in zip(ckpt.flatten_with_paths(got),
                                     jckpt._flatten_with_paths(want)):
        assert path == path2
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-5,
                                   err_msg=path)


# ---- checkpoints across packages and resume ------------------------------

def _bf16_lm_state(seed: int):
    """A bf16 smoke-LM train state of the reference (params from
    ``init_params``, adamw moments filled from ``seed``, step 3) as numpy,
    and the port's state made from it."""
    jcfg = dataclasses.replace(jbase.get(LM).make_smoke_config(),
                               dtype=jnp.bfloat16)
    cfg = dataclasses.replace(base.get(LM).make_smoke_config(),
                              dtype=torch.bfloat16)
    jo = jopt.chain(jopt.clip_by_global_norm(1.0), jopt.adamw(1e-3))
    jparams = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    opt_state = jax.tree.map(      # moments in [0, 1): v must not be < 0
        lambda x: rng.random(x.shape).astype(np.float32)
        if x.dtype == jnp.float32 else np.asarray(3, np.int32),
        jo.init(jparams))
    jstate = jtrainer.TrainState(jax.tree.map(np.asarray, jparams),
                                 opt_state, np.asarray(3, np.int32))
    model = tf.LM(cfg, device="cpu")
    to = opt_lib.chain(opt_lib.clip_by_global_norm(1.0), opt_lib.adamw(1e-3))
    state = init_state(dict(model.named_parameters()), to)
    return jstate, state, model


def test_bf16_train_state_checkpoint_crosses_packages(tmp_path):
    """Each package restores the other's bf16 TrainState checkpoint bit
    for bit, and both write the same manifest (leaf keys, file order,
    shapes, dtypes)."""
    jstate, state, _ = _bf16_lm_state(0)
    convert.train_state_from_jax(jstate, state)
    assert state.params["head"].dtype == torch.bfloat16
    assert int(state.step) == 3
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save(port_dir, 3, convert.train_state_to_numpy(state))
    jckpt.save(ref_dir, 3, jax.tree.map(jnp.asarray, jstate))
    assert (ckpt.read_manifest(port_dir, 3)["index"]
            == jckpt.read_manifest(ref_dir, 3)["index"])

    like = jax.tree.map(jnp.asarray, jstate)
    from_port, _ = jckpt.restore(port_dir, 3, like)
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(like)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()

    _, fresh, _ = _bf16_lm_state(1)
    tree, _ = ckpt.restore(ref_dir, 3, convert.train_state_to_numpy(fresh))
    convert.train_state_from_jax(tree, fresh)
    for (path, a), (_, b) in zip(
            ckpt.flatten_with_paths(convert.train_state_to_numpy(fresh)),
            ckpt.flatten_with_paths(convert.train_state_to_numpy(state))):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                else np.array_equal(a, b)), path


def test_bf16_lm_resume_equals_uninterrupted_run(tmp_path):
    """The bf16 smoke LM, 5 steps of the launcher's optimizer: a run
    crashed at step 3 and resumed from its step-2 checkpoint ends bit for
    bit where the uninterrupted run ends."""
    jstate, _, _ = _bf16_lm_state(2)
    batches = [_torch_batch(b) for b in _lm_batches(9, 5, 4, 32, 512)]
    quiet = dict(log_every=100, log_fn=lambda s: None)

    def fresh():
        _, state, model = _bf16_lm_state(2)
        convert.train_state_from_jax(jstate, state)
        step = make_train_step(lambda p, b: tf.lm_loss(model, b),
                               opt_lib.chain(opt_lib.clip_by_global_norm(1.0),
                                             opt_lib.adamw(1e-3)))
        return state, step

    state, step = fresh()
    state = state._replace(step=torch.zeros((), dtype=torch.int32))
    whole = train_loop(state, step, iter(batches), n_steps=5, **quiet)
    state, step = fresh()
    state = state._replace(step=torch.zeros((), dtype=torch.int32))
    cdir = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="simulated"):
        train_loop(state, step, iter(batches), n_steps=5, ckpt_dir=cdir,
                   ckpt_every=2, fail_at_step=3, **quiet)
    assert ckpt.latest_step(cdir) == 2
    state, step = fresh()
    tree, _ = ckpt.restore(cdir, 2, convert.train_state_to_numpy(state))
    state = convert.train_state_from_jax(tree, state)
    resumed = train_loop(state, step, iter(batches[2:]), n_steps=5, **quiet)
    assert int(resumed.step) == int(whole.step) == 5
    for k, p in whole.params.items():
        assert torch.equal(resumed.params[k], p), k


# ---- recsys losses under autograd ---------------------------------------

RECSYS = ["deepfm", "xdeepfm", "din", "two-tower-retrieval"]


def _recsys_batch(arch, cfg, rng, rows=16):
    def ids(vocab_sizes):
        return np.stack([rng.integers(0, v, rows) for v in vocab_sizes],
                        -1).astype(np.int32)

    if arch in ("deepfm", "xdeepfm"):
        return {"sparse": ids(cfg.embedding.vocab_sizes),
                "label": (rng.random(rows) < 0.3).astype(np.float32)}
    if arch == "din":
        vs, t = cfg.embedding.vocab_sizes, cfg.seq_len
        return {"hist": ids((vs[0],) * t),
                "hist_mask": np.arange(t)[None, :]
                < rng.integers(1, t + 1, (rows, 1)),
                "target": ids(vs[:1])[:, 0], "profile": ids(vs[1:]),
                "label": (rng.random(rows) < 0.5).astype(np.float32)}
    return {"user_feats": ids(cfg.user_embedding.vocab_sizes),
            "item_feats": ids(cfg.item_embedding.vocab_sizes),
            "log_q": rng.standard_normal(rows).astype(np.float32)}


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_loss_grads_match_reference(arch):
    """Every parameter's gradient, the tables' dense ones included."""
    jcfg = jbase.get(arch).make_smoke_config()
    cfg = base.get(arch).make_smoke_config()
    init, jloss, loss = {
        "deepfm": (jrec.init_ctr_params, jrec.ctr_loss, recsys.ctr_loss),
        "xdeepfm": (jrec.init_ctr_params, jrec.ctr_loss, recsys.ctr_loss),
        "din": (jrec.init_din_params, jrec.din_loss, recsys.din_loss)}.get(
        arch, (jrec.init_twotower_params, jrec.twotower_loss,
               recsys.twotower_loss))
    jparams = init(jax.random.PRNGKey(3), jcfg)
    model = convert.recsys_params_from_jax(jax.tree.map(np.asarray, jparams),
                                           cfg, device="cpu")
    batch = _recsys_batch(arch, cfg, np.random.default_rng(4))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, _jax_batch(batch), jcfg)))(jparams)
    params = dict(model.named_parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = loss(model, tb, cfg)
    grads = torch.autograd.grad(got, list(params.values()))
    np.testing.assert_allclose(float(got.detach()), float(jl), rtol=1e-5)
    _close_to_leaf_max(_ref_grads_tree(params, grads),
                       jax.tree.map(np.asarray, jg), arch)
    table = "table" if "table" in params else "user_table"
    assert params[table].grad is None            # autograd.grad leaves none
    assert grads[list(params).index(table)].layout == torch.strided


# ---- the launcher, data and imports ----------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmoe-1b-7b", "gat-cora",
                                  "deepfm", "two-tower-retrieval"])
def test_launcher_smoke_recovers_from_a_failure(arch, tmp_path, capsys):
    rc = launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--steps", "8", "--ckpt-dir",
                            str(tmp_path / "ck"), "--ckpt-every", "4",
                            "--simulate-failure", "6"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "worker failure" in out
    assert "restored step 4" in out
    assert "training complete at step 8" in out
    # a rerun against the same directory restores the last step and stops
    assert launch_train.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--steps", "8", "--ckpt-dir",
                              str(tmp_path / "ck")]) == 0
    assert "restored step 8" in capsys.readouterr().out


def test_launcher_without_smoke_exits_2(capsys):
    assert launch_train.main(["--arch", LM]) == 2
    assert "production mesh" in capsys.readouterr().out


def test_lm_token_batches_are_shifted_zipf_tokens():
    gen = torch.Generator().manual_seed(0)
    batches = list(synthetic.lm_token_batches(gen, 4, 64, 512, n_batches=3))
    assert len(batches) == 3
    for b in batches:
        assert b["tokens"].shape == b["labels"].shape == (4, 64)
        assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])
        assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 512
    # Zipf-ish: the low ranks dominate
    assert float((batches[0]["tokens"] < 8).float().mean()) > 0.5


def test_new_modules_import_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.train.optimizer, "
            "repro_torch.train.trainer, repro_torch.train.compression, "
            "repro_torch.launch.train, repro_torch.models.gat, "
            "repro_torch.data.graph, repro_torch.configs.gat_cora; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": SRC, "PATH": ""},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# -- bf16 gathers of repeated rows: the backward adds in float32 ------------


def _repeated_rows(n_rows: int, n_take: int, hot: int, repeats: int):
    rng = np.random.default_rng(7)
    index = rng.integers(0, n_rows, n_take)
    index[rng.choice(n_take, repeats, replace=False)] = hot
    return torch.from_numpy(index)


@pytest.mark.parametrize("site", ["embed", "head", "embedding_bag"])
def test_bf16_gather_backward_adds_in_float32(site):
    """A row taken ~500 times (a frequent token): each gather site's bf16
    backward against float64 on the same bf16 values. The float32 sum
    rounded once to bf16 lies within one bf16 ulp (2^-8 relative) of the
    float64 gradient; adding the 500 terms in bf16, as autograd's own
    ``index_put_``/``index_add_`` do, lands several percent off."""
    from repro_torch.models import embedding
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(300, 16, generator=gen).to(torch.bfloat16)
    index = _repeated_rows(300, 2048, hot=5, repeats=500)
    cot = torch.randn(2048, 16, generator=gen).to(torch.bfloat16)
    dim = 0
    if site == "embed":
        cfg = dataclasses.replace(base.get(LM).make_smoke_config(),
                                  vocab=300, d_model=16)
        model = tf.LM(cfg, "cpu")
        with torch.no_grad():
            model.embed = torch.nn.Parameter(table.clone())
        lay = tf._Layout(cfg, None)
        take = lambda t: tf._embed(model, index[None], lay)[0]  # noqa: E731
        leaf = model.embed
    elif site == "head":
        table, dim, cot = table.t().contiguous(), 1, cot.t().contiguous()
        take = lambda t: embedding.gather_rows(t, index, 1)    # noqa: E731
    else:
        take = lambda t: embedding.embedding_bag(t, index)     # noqa: E731
    if site != "embed":
        leaf = table.requires_grad_(True)
    got = torch.autograd.grad((take(leaf).float() * cot.float()).sum(),
                              leaf)[0]
    t64 = leaf.detach().double().requires_grad_(True)
    want = torch.autograd.grad(
        (torch.index_select(t64, dim, index) * cot.double()).sum(), t64)[0]
    assert got.dtype == torch.bfloat16
    hot = got.select(dim, 5).double()
    rel = float((hot - want.select(dim, 5)).norm()
                / want.select(dim, 5).norm())
    assert rel <= 2.0 ** -8, rel
    assert torch.equal(take(leaf.detach()), torch.index_select(
        leaf.detach(), dim, index).reshape(take(leaf.detach()).shape))

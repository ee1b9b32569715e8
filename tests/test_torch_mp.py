"""The port's model-parallel serving paths (slice 16) in gloo worlds on the
CPU, held against the JAX reference and the single-device port.

Two worlds, each spawned once: ("data", "model") meshes of (1, 2) and
(2, 2) (``tests/torch_mp_worker.py`` is the rank body, free of JAX). The
inputs are made with numpy from a seed; the models are the reference's
parameters (numpy draws at the shapes of its ``init_params``,
``init_twotower_params(table_pad=8)`` and ``init_moe_params``), cut into each
rank's shard by ``models/convert.py``. The reference's mesh semantics are
its single-device ones within float tolerance (its TP/SP prefill and its
sharded lookup and EP were run on an 8-device host mesh against
``NO_SHARDING``), so the ranks are held against the reference's
single-device functions, and against its per-shard composition where the
mesh changes the answer (EP's capacity is per shard). Held, float32:

* ``sharding(name)``: the placements of every rule of ``lm_rules`` (both
  sets) and ``_lm_rules`` (prefill with and without head TP, decode,
  long-context decode) read back as the reference's ``PartitionSpec``;
* ``relayout`` round trips and partial sums; ``all_to_all`` against
  JAX's tiled semantics; the refusals;
* the row-sharded ``embedding_bag`` against the reference's (atol 1e-6);
* EP ``moe_ffn`` against the reference's ``_moe_local`` on each rank's
  tokens at the local capacity (drop counts exact) and, at capacity
  factor 8, against its ``NO_SHARDING`` ``moe_ffn`` (atol 2e-4, the
  reference's own);
* TP/SP ``prefill`` (the dense LM with the flash path's plain version,
  and with replicated heads; the MoE LM at a capacity factor where
  nothing drops): last logits and the gathered cache against the
  reference's ``prefill`` (rtol 1e-4, atol 1e-5, as the LM tests: the two
  frameworks sum in other orders); split-KV ``decode_step`` under both
  decode rule sets against the reference's ``decode_step`` on the same
  tokens, and ``greedy`` against its argmax;
* ``sah_retrieve_step`` over row-sharded tables: the user vector bitwise
  the single-device tower's, and the ids bitwise the single-device
  composition of the sharded scan (each shard's ``n_cand`` nearest,
  merged).

Training (slice 17's training half), under the train rules of
``_lm_rules`` and held against the reference's single-device functions:

* ``lm_loss`` against ``jtf.lm_loss`` (rtol 1e-5) and every gradient,
  reduced by the trainer's rule and gathered whole, against ``jax.grad``
  of it (rtol 1e-4, atol 1e-6): the dense LM with head TP and with
  replicated heads, and the MoE LM (capacity where nothing drops; aux
  weight 0, since a mesh's aux is the mean of the shards' as the
  reference's ``shard_map`` has it, not one device's);
* two steps of ``default_optimizer("lm")`` (clip + Adafactor) and of clip
  + AdamW: losses and gradient norms (rtol 1e-5) and the gathered
  parameters (rtol 1e-4) against the reference's ``make_train_step``;
  ``grad_accum=2`` under the mesh against ``grad_accum=1``;
* EP ``moe_ffn``'s gradients at capacity factor 1.25 against
  ``jax.grad`` of the per-shard composition at the local capacity (drop
  counts exact);
* ``compressed_psum`` against a numpy replay of the reference's formula
  (bitwise: the int32 sums are exact);
* the checkpoint each world saves read by the reference's ``restore``
  and the port's single-device one bit for bit, and the (2, 2) world's
  restored on a (1, 2) mesh of two of its ranks bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_mp_worker as W
from repro.configs import base as jbase
from repro.dist.policy import NO_SHARDING as JAX_NO_SHARDING
from repro.dist.policy import ShardingPolicy as JaxPolicy
from repro.dist.policy import lm_rules as jax_lm_rules
from repro.launch import cells as jcells
from repro.models import embedding as jemb
from repro.models import gat as jgat
from repro.models import moe as jmoe
from repro.models import recsys as jrec
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer

from repro_torch.configs import base
from repro_torch.dist import ShardingPolicy, lm_rules
from repro_torch.engine import sharding
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch import serve
from repro_torch.models import convert, recsys
from repro_torch.models import transformer as tf
from repro_torch.train import checkpoint as ckpt

LM_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
EP_AUX_WEIGHT = 0.5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix: str, out: dict) -> dict:
    """A nest of dicts and lists as {"prefix/a/0/b": array}."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        if isinstance(value, (dict, list, tuple)):
            _flat(value, f"{prefix}/{key}", out)
        else:
            out[f"{prefix}/{key}"] = np.array(value)
    return out


def _jax_dense():
    return jtf.LMConfig(**W.DENSE, dtype=jnp.float32, max_seq=W.MAX_SEQ)


def _jax_moe_lm():
    cfg = jbase.get("olmoe-1b-7b").make_smoke_config()
    return dataclasses.replace(
        cfg, max_seq=W.MOE_PROMPT[1] + W.MOE_DECODE,
        moe=dataclasses.replace(cfg.moe, capacity_factor=float(
            cfg.moe.n_experts // cfg.moe.top_k)))


def _draw(shapes, rng, path=""):
    """numpy draws at the shapes of a reference ``init_*`` (from
    ``jax.eval_shape``; jitting its ``jax.random`` draws costs seconds a
    shape on the CPU): matrices N(0, 1) * fan_in^-0.5 (the embedding and
    the tables N(0, 1) / 4), norm scales 1 + N(0, 0.1^2), biases N(0,
    0.1^2), so every slice a rank holds matters."""
    if isinstance(shapes, dict):
        return {k: _draw(v, rng, f"{path}/{k}") for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_draw(v, rng, f"{path}/{i}") for i, v in enumerate(shapes)]
    leaf, shape = path.rsplit("/", 1)[-1], shapes.shape
    x = rng.standard_normal(shape)
    if leaf in ("embed", "user_table", "item_table"):
        x = x / 4
    elif leaf in ("ln1", "ln2", "q_norm", "k_norm", "final_norm"):
        x = 1 + 0.1 * x
    elif leaf in ("bq", "bk", "bv", "b") or len(shape) < 2:
        x = 0.1 * x
    else:
        x = x * shape[-2] ** -0.5
    return x.astype(shapes.dtype)


def _lm_reference(jcfg, rng, tokens_shape, n_decode):
    """The reference's parameters (numpy), tokens, prefill and
    ``n_decode`` greedy decode steps (each jitted once) -> (params,
    tokens, last logits, cache k, cache v, step logits (n, B, V), the
    tokens fed to each step (n, B))."""
    params = _draw(jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                                  jax.random.PRNGKey(0)), rng)
    tokens = rng.integers(0, jcfg.vocab, tokens_shape).astype(np.int32)
    prefill = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg))
    decode = jax.jit(lambda p, c, t: jtf.decode_step(p, c, t, jcfg))
    logits, cache = prefill(params, jnp.asarray(tokens))
    out = [params, tokens, np.asarray(logits), np.asarray(cache["k"]),
           np.asarray(cache["v"])]
    steps, teach = [], []
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)
    for _ in range(n_decode):
        teach.append(np.asarray(nxt))
        logits_s, cache = decode(params, cache, nxt)
        steps.append(np.asarray(logits_s))
        nxt = jnp.argmax(logits_s, -1).astype(jnp.int32)
    v = jcfg.vocab
    return out + [np.array(steps).reshape(n_decode, tokens.shape[0], v),
                  np.array(teach, dtype=np.int32).reshape(n_decode, -1)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs every rank loads, and the reference's answers."""
    rng = np.random.default_rng(W.SEED)
    key = jax.random.PRNGKey(W.SEED)
    inputs, want = {}, {}
    for prefix, jcfg, shape, steps in (
            ("lm", _jax_dense(), W.PROMPT, W.N_DECODE),
            ("moe_lm", _jax_moe_lm(), W.MOE_PROMPT, W.MOE_DECODE)):
        (params, inputs[f"{prefix}/tokens"], want[f"{prefix}/logits"],
         want[f"{prefix}/cache_k"], want[f"{prefix}/cache_v"],
         want[f"{prefix}/steps"], inputs[f"{prefix}/teach"]) = \
            _lm_reference(jcfg, rng, shape, steps)
        _flat(params, f"{prefix}/params", inputs)

    # the row-sharded lookup (the reference test's shapes)
    inputs["emb/table"] = rng.standard_normal((64, 8)).astype(np.float32)
    inputs["emb/rows"] = rng.integers(0, 64, (16, 3)).astype(np.int32)
    want["emb"] = np.asarray(jemb.embedding_bag(
        jnp.asarray(inputs["emb/table"]), jnp.asarray(inputs["emb/rows"]),
        JAX_NO_SHARDING))

    # expert parallelism: weights at init_moe_params' shapes and scales
    b, s, d = W.EP_TOKENS
    jm = jmoe.MoEConfig(**W.MOE, capacity_factor=1.25)
    shapes = jax.eval_shape(lambda k: jmoe.init_moe_params(k, d, jm), key)
    scale = {"router": d ** -0.5, "w_in": d ** -0.5, "w_gate": d ** -0.5,
             "w_out": W.MOE["d_ff_expert"] ** -0.5}
    mp = {name: (rng.standard_normal(sd.shape) * scale[name]).astype(
        np.float32) for name, sd in shapes.items()}
    x = rng.standard_normal(W.EP_TOKENS).astype(np.float32)
    _flat(mp, "moe/params", inputs)
    inputs["moe/x"] = x
    want["moe/params"], want["moe/x"] = mp, x
    want["moe8"] = np.asarray(jmoe.moe_ffn(
        jnp.asarray(x), jax.tree.map(jnp.asarray, mp),
        dataclasses.replace(jm, capacity_factor=8.0), JAX_NO_SHARDING)[0])

    # two-tower: padded tables, random candidates indexed by the port
    tcfg = jbase.get("two-tower-retrieval").make_smoke_config()
    tparams = _draw(jax.eval_shape(lambda k: jrec.init_twotower_params(
        k, tcfg, table_pad=8), key), rng)
    _flat(tparams, "tt/params", inputs)
    cand = rng.standard_normal((W.TT_CAND, tcfg.out_dim)).astype(np.float32)
    codes, proj = serve.build_candidate_index(
        torch.from_numpy(cand), torch.Generator().manual_seed(W.SEED),
        device="cpu")
    inputs["tt/cand"], inputs["tt/codes"] = cand, codes.numpy()
    inputs["tt/proj"] = proj.numpy()
    inputs["tt/users"] = np.stack(
        [rng.integers(0, v, W.TT_USERS) for v in
         tcfg.user_embedding.vocab_sizes], axis=1).astype(np.int32)
    want["tt/params"] = tparams

    _train_reference(inputs, want, tmp_path_factory)
    _gat_reference(inputs, want)
    _recsys_reference(inputs, want)
    path = tmp_path_factory.mktemp("mp_inputs") / "inputs.npz"
    np.savez(path, **inputs)
    return str(path), inputs, want


def _jax_train(**kw):
    return jtf.LMConfig(**{**W.DENSE, "qkv_bias": False, **kw},
                        dtype=jnp.float32, max_seq=W.MAX_SEQ)


def _batch(tokens) -> dict:
    t = jnp.asarray(tokens)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _train_reference(inputs, want, tmp_path_factory):
    """The training checks' inputs (their own rng, so the serving draws
    stay as they were) and the reference's answers: loss and gradients of
    the dense and MoE LMs, and two steps of each optimizer."""
    rng = np.random.default_rng(W.SEED + 1)
    b, s = W.TRAIN_BATCH
    inputs["train/tokens"] = rng.integers(
        0, W.DENSE["vocab"], (W.TRAIN_STEPS, b, s + 1)).astype(np.int32)
    moe_cfg = dataclasses.replace(_jax_moe_lm(), aux_loss_weight=0.0)
    inputs["train/moe_tokens"] = rng.integers(
        0, moe_cfg.vocab, (1, b, s + 1)).astype(np.int32)
    tcfg = _jax_train()
    tparams = _draw(jax.eval_shape(lambda k: jtf.init_params(k, tcfg),
                                   jax.random.PRNGKey(0)), rng)
    _flat(tparams, "train/params", inputs)
    inputs["train/ckpt_dir"] = np.array(str(tmp_path_factory.mktemp(
        "mp_ckpt")))
    inputs["moe/cot"] = rng.standard_normal(W.EP_TOKENS).astype(np.float32)
    inputs["moe/aux_weight"] = np.array(EP_AUX_WEIGHT)
    inputs["cp/x"] = (rng.standard_normal(W.CP_SHAPE)
                      * np.array([1.0, 3.0, 0.5, 2.0])[:, None]
                      ).astype(np.float32)

    for prefix, cfg, params, tokens in (
            ("grad_lm", _jax_dense(), "lm/params", "train/tokens"),
            ("grad_moe_lm", moe_cfg, "moe_lm/params", "train/moe_tokens")):
        tree = jax.tree.map(jnp.asarray, W.unflatten(inputs, params))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, bt, c=cfg: jtf.lm_loss(
                p, bt, c, loss_chunk=W.TRAIN_LOSS_CHUNK)))(
            tree, _batch(inputs[tokens][0]))
        want[prefix] = (float(loss), jax.tree.map(np.asarray, grads))

    jp = jax.tree.map(jnp.asarray, tparams)
    for name, opt in (("adafactor", jcells.default_optimizer("lm")),
                      ("adamw", jopt.chain(jopt.clip_by_global_norm(1.0),
                                           jopt.adamw(**W.ADAMW)))):
        step = jax.jit(jtrainer.make_train_step(
            lambda p, bt: jtf.lm_loss(p, bt, tcfg,
                                      loss_chunk=W.TRAIN_LOSS_CHUNK), opt))
        state = jtrainer.TrainState(jp, opt.init(jp),
                                    jnp.zeros((), jnp.int32))
        seen = []
        for tokens in inputs["train/tokens"]:
            state, m = step(state, _batch(tokens))
            seen.append((float(m["loss"]), float(m["grad_norm"])))
        want[name] = (np.array(seen), jax.tree.map(np.asarray, state))


def _gat_reference(inputs, want):
    """GAT's inputs (their own rng) and the reference's single-device
    loss and gradients: a node-level graph for each aggregation, the
    dst-partitioned one drawn in owner blocks (every edge of block b
    points into the b-th block of nodes), the all-reduce one with a
    masked tail (dead edges at node 0) and a node no edge reaches."""
    rng = np.random.default_rng(W.SEED + 2)
    jcfg = jbase.get("gat-cora").make_smoke_config()
    g = W.GAT_GRAPH
    n, e, blocks = g["n"], g["e"], g["blocks"]
    params = _draw(jax.eval_shape(lambda k: jgat.init_params(k, jcfg),
                                  jax.random.PRNGKey(0)), rng)
    _flat(params, "gat/params", inputs)
    x = rng.standard_normal((n, jcfg.d_in)).astype(np.float32)
    labels = rng.integers(0, jcfg.n_classes, n).astype(np.int32)
    label_mask = rng.random(n) < 0.7
    src = rng.integers(0, n, e).astype(np.int32)
    dst = {"allreduce": rng.integers(0, n - 1, e).astype(np.int32),
           "dst_partitioned": ((np.arange(e) // (e // blocks))
                               * (n // blocks)
                               + rng.integers(0, n // blocks, e)
                               ).astype(np.int32)}
    for mode, d in dst.items():
        emask = np.ones(e, bool)
        s_ = src.copy()
        if mode == "allreduce":
            emask[-e // 8:] = False
            s_[-e // 8:], d = 0, np.where(emask, d, 0).astype(np.int32)
        graph = {"x": x, "src": s_, "dst": d, "edge_mask": emask,
                 "labels": labels, "label_mask": label_mask}
        inputs.update({f"gat/{mode}/{k}": v for k, v in graph.items()})
        jc = dataclasses.replace(jcfg, agg_mode=mode)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, gr, c=jc: jgat.loss_fn(p, gr, c)))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in graph.items()})
        want[f"gat_{mode}"] = (float(loss), jax.tree.map(np.asarray, grads))


_RECSYS_INIT = {"deepfm": (jrec.init_ctr_params, jrec.ctr_loss),
                "din": (jrec.init_din_params, jrec.din_loss),
                "two-tower-retrieval": (jrec.init_twotower_params,
                                        jrec.twotower_loss)}


def _recsys_reference(inputs, want):
    """The recsys training checks' inputs (their own rng): the
    reference's parameters with tables padded to 8 rows, a global batch of
    ``W.RECSYS_BATCH`` rows (ids uniform over each field, DIN histories of
    a uniform prefix length, labels in {0, 1}, a non-zero ``log_q``), and
    ``jax.value_and_grad`` of the reference's single-device loss."""
    rng = np.random.default_rng(W.SEED + 3)
    b = W.RECSYS_BATCH

    def fields(vocab):
        return np.stack([rng.integers(0, v, b) for v in vocab],
                        axis=1).astype(np.int32)

    for arch_id in W.RECSYS_TRAIN:
        init, loss_fn = _RECSYS_INIT[arch_id]
        cfg = jbase.get(arch_id).make_smoke_config()
        params = _draw(jax.eval_shape(lambda k, c=cfg, f=init: f(
            k, c, table_pad=8), jax.random.PRNGKey(0)), rng)
        if arch_id == "deepfm":
            batch = {"sparse": fields(cfg.embedding.vocab_sizes)}
        elif arch_id == "din":
            t, vocab = cfg.seq_len, cfg.embedding.vocab_sizes
            batch = {"hist": fields((vocab[0],) * t),
                     "hist_mask": (np.arange(t)
                                   < rng.integers(1, t + 1, (b, 1))),
                     "target": rng.integers(0, vocab[0], b).astype(
                         np.int32),
                     "profile": fields(vocab[1:])}
        else:
            batch = {"user_feats": fields(cfg.user_embedding.vocab_sizes),
                     "item_feats": fields(cfg.item_embedding.vocab_sizes),
                     "log_q": (0.1 * rng.standard_normal(b)).astype(
                         np.float32)}
        if arch_id != "two-tower-retrieval":
            batch["label"] = rng.integers(0, 2, b).astype(np.float32)
        _flat(params, f"rs/{arch_id}/params", inputs)
        inputs.update({f"rs/{arch_id}/batch/{k}": v
                       for k, v in batch.items()})
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, bt, c=cfg, f=loss_fn: f(p, bt, c)))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
        want[f"rs_{arch_id}"] = (float(loss), convert._named_leaves(
            jax.tree.map(np.asarray, grads)))


@pytest.fixture(scope="module", params=list(W.WORLDS))
def world(request, reference, tmp_path_factory):
    """(name, mesh shape, each rank's arrays) of one world, spawned once."""
    path = tmp_path_factory.mktemp(f"mp_world_{request.param}")
    ranks = W.spawn_world(request.param, str(path), reference[0])
    return request.param, W.WORLDS[request.param], ranks


def _norm(spec) -> tuple:
    return tuple(spec)


def _reference_rules(name: str, shape: tuple) -> dict:
    mesh = type("M", (), {"shape": dict(zip(("data", "model"), shape))})()
    if name in ("tp", "pure_dp"):
        return jax_lm_rules(("data",), "model", pure_dp=name == "pure_dp")
    arch = jbase.get("qwen2-1.5b" if name == "prefill_no_tp_heads"
                     else "qwen3-0.6b")
    kind = "prefill" if name.startswith("prefill") else "decode"
    return jcells._lm_rules(arch, kind, mesh, long_ctx=name == "long_ctx")


# -- the policy ---------------------------------------------------------------


def test_sharding_placements_match_the_reference(world):
    _, shape, ranks = world
    for name in W.RULE_SETS:
        want = _reference_rules(name, shape)
        for rule, spec in want.items():
            for got in ranks:
                assert str(got[f"rules/{name}/{rule}"]) == repr(
                    _norm(spec)), (name, rule)


def test_lm_rules_of_the_cells_match_the_reference():
    """``_lm_rules`` as data, without a mesh's placements."""
    for shape in ((1, 2), (2, 2), (16, 16)):
        mesh = type("M", (), {"mesh_dim_names": ("data", "model"),
                              "size": lambda self, s=shape: s[0] * s[1]})()
        for name in W.RULE_SETS[2:]:
            got = W.rule_set(name, mesh)
            want = _reference_rules(name, shape)
            assert got == {k: _norm(v) for k, v in want.items()}, name


def test_param_specs_match_the_reference():
    for arch in ("qwen3-0.6b", "olmoe-1b-7b", "qwen2-1.5b"):
        jcfg = jbase.get(arch).make_smoke_config()
        cfg = base.get(arch).make_smoke_config()
        want = jtf.param_specs(jcfg, JaxPolicy(rules=jax_lm_rules(
            ("data",), "model")))
        got = tf.param_specs(cfg, ShardingPolicy(rules=lm_rules(
            ("data",), "model")))
        assert jax.tree.map(_norm, want, is_leaf=lambda x: isinstance(
            x, P)) == got, arch


@pytest.mark.parametrize("arch", ["two-tower-retrieval", "deepfm", "din"])
def test_recsys_table_pad_matches_the_reference(arch):
    """``init_*_params(table_pad=)`` pads the tables as the reference does:
    every leaf's shape equals the reference's at the same pad."""
    jcfg = jbase.get(arch).make_smoke_config()
    cfg = base.get(arch).make_smoke_config()
    jinit, init = {"two-tower-retrieval": (jrec.init_twotower_params,
                                           recsys.init_twotower_params),
                   "deepfm": (jrec.init_ctr_params, recsys.init_ctr_params),
                   "din": (jrec.init_din_params, recsys.init_din_params)}[arch]
    want = jax.eval_shape(lambda k: jinit(k, jcfg, table_pad=8),
                          jax.random.PRNGKey(0))
    want = {k: tuple(v.shape) for k, v in convert._named_leaves(want).items()}
    model = init(torch.Generator().manual_seed(0), cfg, device="cpu",
                 table_pad=8)
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == want
    for name in recsys.TABLES[type(model).__name__]:
        assert getattr(model, name).shape[0] % 8 == 0


def test_relayout_round_trips(world):
    for got in world[2]:
        assert got["relayout/ok"].all(), got["relayout/ok"]
        assert got["pmax"][0] == world[1][1] - 1


def test_all_to_all_has_jax_tiled_semantics(world):
    assert all(bool(got["a2a/ok"]) for got in world[2])


def test_refusals(world):
    for got in world[2]:
        assert "relayout" in str(got["refuse/constrain"])
        msg = str(got["refuse/indivisible"])
        assert "embed" in msg and "dim 0" in msg and "127" in msg
        assert "mesh's order" in str(got["refuse/order"])


def test_mismatched_calls_raise_on_every_rank(world):
    """A call the ranks disagree on raises on every rank (none is left
    waiting in a collective): tokens that differ along "model", a rank
    that passes the whole model, ranks at different decode steps."""
    for got in world[2]:
        assert "different tokens" in str(got["refuse/tokens"])
        assert "at steps" in str(got["refuse/step"])
    shard = [str(got["refuse/shard"]) for got in world[2]]
    assert all("its shard" in msg or "refused the call" in msg
               for msg in shard), shard
    assert any("its shard" in msg for msg in shard), shard
    assert any("refused the call" in msg for msg in shard), shard


def test_sharded_init_equals_the_cut_whole_model(world):
    assert all(bool(got["init/same"]) for got in world[2])


# -- the row-sharded lookup and expert parallelism -------------------------


def test_sharded_embedding_bag_matches_the_reference(world, reference):
    for got in world[2]:
        np.testing.assert_allclose(got["emb/out"], reference[2]["emb"],
                                   atol=1e-6)


def _shards(x, shape):
    """Each rank's (B, S) block of x under act_btd, in rank order."""
    dp, tp = shape
    b, s = x.shape[0] // dp, x.shape[1] // tp
    return [x[i * b:(i + 1) * b, j * s:(j + 1) * s]
            for i in range(dp) for j in range(tp)]


def test_expert_parallel_moe_is_the_per_shard_composition(world, reference):
    """EP at capacity factor 1.25, where experts overflow: each rank's
    tokens through the reference's ``_moe_local`` at the local capacity."""
    _, shape, ranks = world
    want = reference[2]
    mp = jax.tree.map(jnp.asarray, want["moe/params"])
    cfg = jmoe.MoEConfig(**W.MOE, capacity_factor=1.25)
    x = want["moe/x"]
    @functools.partial(jax.jit, static_argnums=1)
    def local(x2d, cap):
        o, aux = jmoe._moe_local(x2d, mp, cfg, cap, mp["w_in"],
                                 mp["w_gate"], mp["w_out"])
        _, top_e = jax.lax.top_k(jax.nn.softmax(x2d @ mp["router"]),
                                 cfg.top_k)
        return o, aux, jmoe._dispatch_indices(top_e.reshape(-1),
                                              cfg.n_experts, cap)[1]

    outs, drops, auxes = [], [], []
    for xs in _shards(x, shape):
        x2d = jnp.asarray(xs.reshape(-1, x.shape[-1]))
        t = x2d.shape[0]
        cap = max(cfg.top_k, int(cfg.capacity_factor * t * cfg.top_k
                                 / cfg.n_experts))
        o, aux, keep = local(x2d, cap)
        outs.append(np.asarray(o).reshape(xs.shape))
        drops.append(int((~np.asarray(keep)).sum()))
        auxes.append(float(aux))
    dp, tp = shape
    whole = np.concatenate([np.concatenate(outs[i * tp:(i + 1) * tp], 1)
                            for i in range(dp)], 0)
    assert sum(drops) > 0                   # the check sees drops
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["moe1.25/out"], whole, atol=2e-4)
        assert int(got["moe1.25/dropped"]) == drops[r]
        np.testing.assert_allclose(got["moe1.25/aux"], np.mean(auxes),
                                   rtol=1e-5)


def test_expert_parallel_moe_matches_no_sharding(world, reference):
    for got in world[2]:
        assert int(got["moe8.0/dropped"]) == 0
        np.testing.assert_allclose(got["moe8.0/out"], reference[2]["moe8"],
                                   atol=2e-4)


# -- the LM: TP/SP prefill and split-KV decode -------------------------------


@pytest.mark.parametrize("prefix", ["lm", "moe_lm"])
def test_tp_sp_prefill_matches_the_reference(world, reference, prefix):
    want = reference[2]
    for got in world[2]:
        np.testing.assert_allclose(got[f"{prefix}/logits"],
                                   want[f"{prefix}/logits"], **LM_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(got[f"{prefix}/cache_{name}"],
                                       want[f"{prefix}/cache_{name}"],
                                       **LM_TOL)
        np.testing.assert_array_equal(got[f"{prefix}/greedy0"],
                                      want[f"{prefix}/logits"].argmax(-1))


def test_prefill_with_replicated_heads_matches_the_reference(world,
                                                             reference):
    """``tp_heads=False`` rules (qwen2-1.5b's): q/k/v gathered to every
    head on each rank, the chunked attention, the same answer."""
    for got in world[2]:
        np.testing.assert_allclose(got["lm_heads/logits"],
                                   reference[2]["lm/logits"], **LM_TOL)


@pytest.mark.parametrize("prefix,rules", [("lm", "decode"),
                                          ("lm", "long_ctx"),
                                          ("moe_lm", "decode")])
def test_split_kv_decode_matches_the_reference(world, reference, prefix,
                                               rules):
    want = reference[2][f"{prefix}/steps"]
    for got in world[2]:
        np.testing.assert_allclose(got[f"{prefix}/{rules}/logits"], want,
                                   **LM_TOL)
        np.testing.assert_array_equal(got[f"{prefix}/{rules}/greedy"],
                                      want.argmax(-1))
        n = want.shape[0]
        assert int(got[f"{prefix}/{rules}/length"]) == \
            reference[1][f"{prefix}/tokens"].shape[1] + n


# -- two-tower retrieval over row-sharded tables ---------------------------


def test_sah_retrieve_step_is_bitwise(world, reference):
    _, shape, ranks = world
    inputs = reference[1]
    tcfg = base.get("two-tower-retrieval").make_smoke_config()
    model = convert.recsys_params_from_jax(reference[2]["tt/params"], tcfg,
                                           "cpu")
    cand = torch.from_numpy(inputs["tt/cand"])
    codes = torch.from_numpy(inputs["tt/codes"])
    proj = torch.from_numpy(inputs["tt/proj"])
    users = torch.from_numpy(inputs["tt/users"]).long()
    n, shards, k = cand.shape[0], shape[0] * shape[1], W.TT_K
    rows = sharding.pad_item_rows(
        cand, torch.arange(n, dtype=torch.int32),
        torch.ones(n, dtype=torch.bool), codes, shards, k)
    per = rows[0].shape[0] // shards
    assert W.TT_NCAND < per             # the sketch's n_cand binds
    us, ids = [], []
    with torch.no_grad():
        for i in range(users.shape[0]):
            u = recsys.user_tower(model, users[i:i + 1], tcfg)
            qcode = ops.srp_hash(u, proj)
            parts = [sharding.kmips_flat_arrays(
                *(r[s * per:(s + 1) * per] for r in rows), qcode, u, k,
                n_cand=W.TT_NCAND) for s in range(shards)]
            best, pos = kref.topk_stable(torch.cat([v for v, _ in parts], 1),
                                         k)
            ids.append(torch.cat([i for _, i in parts], 1).gather(1, pos)[0])
            us.append(u[0])
    u_want, ids_want = torch.stack(us).numpy(), torch.stack(ids).numpy()
    for got in ranks:
        assert int(got["tt/table_rows"]) * shape[1] == \
            reference[2]["tt/params"]["user_table"].shape[0]
        np.testing.assert_array_equal(got["tt/u"], u_want)
        np.testing.assert_array_equal(got["tt/ids"], ids_want)


# -- training: lm_loss, the train step, EP's backward, compressed_psum, -----
# -- checkpoints --------------------------------------------------------------


def _ref_of(tree, name: str):
    """The reference's leaf (or row of a stacked leaf) for the port's
    parameter ``name``."""
    m = convert._BLOCK.fullmatch(name)
    if not m:
        return tree[name]
    node = tree["layers"]
    for part in m[2].split("."):
        node = node[part]
    return node[int(m[1])]


@pytest.mark.parametrize("prefix,ref", [("grad_lm", "grad_lm"),
                                        ("grad_lm_heads", "grad_lm"),
                                        ("grad_moe_lm", "grad_moe_lm")])
def test_mesh_lm_loss_and_every_gradient_match_the_reference(
        world, reference, prefix, ref):
    """Both head layouts (head TP; heads replicated, so the gathered q/k/v
    carry each rank's share of the gradient) and the MoE LM: every
    parameter's gradient, summed over the axes it is replicated along."""
    loss, grads = reference[2][ref]
    names = [k[len(prefix) + 1:] for k in world[2][0]
             if k.startswith(prefix + "/") and k != f"{prefix}/loss"]
    stacks = convert._named_leaves(grads["layers"])
    n_layers = len(next(iter(stacks.values())))
    assert len(names) == 3 + n_layers * len(stacks)
    for got in world[2]:
        np.testing.assert_allclose(got[f"{prefix}/loss"], loss, rtol=1e-5)
        for name in names:
            np.testing.assert_allclose(got[f"{prefix}/{name}"],
                                       _ref_of(grads, name), **GRAD_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("name", ["adafactor", "adamw"])
def test_mesh_train_steps_match_the_reference(world, reference, name):
    """Two steps from the same parameters on the same global batches: a
    factored statistic that missed its ``pmean`` over a sharded dim, or a
    norm that counted a replicated leaf twice, moves every parameter."""
    seen, state = reference[2][name]
    for got in world[2]:
        np.testing.assert_allclose(got[f"{name}/metrics"], seen, rtol=1e-5)
        for key in got:
            if key.startswith(f"{name}/params/"):
                pname = key[len(name) + 8:]
                np.testing.assert_allclose(
                    got[key], _ref_of(state.params, pname), rtol=1e-4,
                    atol=1e-6, err_msg=pname)


def test_grad_accum_under_a_mesh_equals_one_batch(world):
    """One SGD step with ``grad_accum=2`` (each rank's batch in two
    halves, the gradients reduced once) against ``grad_accum=1``."""
    for got in world[2]:
        np.testing.assert_allclose(got["accum2/metrics"],
                                   got["accum1/metrics"], rtol=1e-5)
        for key in got:
            if key.startswith("accum1/params/"):
                np.testing.assert_allclose(
                    got[key.replace("accum1", "accum2", 1)], got[key],
                    rtol=1e-5, atol=1e-7, err_msg=key)


def test_expert_parallel_backward_is_the_per_shard_composition(world,
                                                               reference):
    """EP at capacity factor 1.25, under grad: the gradients of the
    output (times a fixed cotangent) plus the aux loss against ``jax.grad``
    of each rank's tokens through the reference's ``_moe_local`` at the
    local capacity, the aux the shards' mean; dropped assignments get no
    gradient, and the drops are exact."""
    _, shape, ranks = world
    inputs, want = reference[1], reference[2]
    cfg = jmoe.MoEConfig(**W.MOE, capacity_factor=1.25)
    x, cot = want["moe/x"], inputs["moe/cot"]
    xs, cs = _shards(x, shape), _shards(cot, shape)
    t = xs[0].shape[0] * xs[0].shape[1]
    cap = max(cfg.top_k, int(cfg.capacity_factor * t * cfg.top_k
                             / cfg.n_experts))

    def objective(params, xs):
        total, auxes = 0.0, []
        for x_s, c_s in zip(xs, cs):
            o, aux = jmoe._moe_local(x_s.reshape(-1, x_s.shape[-1]), params,
                                     cfg, cap, params["w_in"],
                                     params["w_gate"], params["w_out"])
            total = total + jnp.sum(o.reshape(c_s.shape) * c_s)
            auxes.append(aux)
        return total + EP_AUX_WEIGHT * jnp.mean(jnp.stack(auxes))

    gp, gx = jax.jit(jax.grad(objective, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, want["moe/params"]),
        [jnp.asarray(a) for a in xs])
    dp, tp = shape
    gx = np.concatenate([np.concatenate([np.asarray(g) for g in
                                         gx[i * tp:(i + 1) * tp]], 1)
                         for i in range(dp)], 0)
    assert sum(int(got["ep/dropped"]) for got in ranks) > 0
    for got in ranks:
        assert int(got["ep/dropped"]) == int(got["moe1.25/dropped"])
        np.testing.assert_allclose(got["ep/grad/x"], gx, rtol=1e-4,
                                   atol=1e-6)
        for name in ("router", "w_in", "w_gate", "w_out"):
            np.testing.assert_allclose(got[f"ep/grad/{name}"],
                                       np.asarray(gp[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


def _compressed_psum_replay(rows: np.ndarray) -> np.ndarray:
    """The reference's ``compressed_psum`` formula in numpy over the
    ranks' rows: the shared scale, int8 values, an int32 sum."""
    s_max = np.float32(max(np.maximum(np.abs(r).max(), np.float32(1e-12))
                           / np.float32(127.0) for r in rows))
    q = [np.clip(np.round(r / s_max), -127, 127).astype(np.int8)
         for r in rows]
    total = np.sum([a.astype(np.int32) for a in q], axis=0, dtype=np.int32)
    return total.astype(np.float32) * s_max


def test_compressed_psum_replays_the_reference_formula(world, reference):
    _, (dp, tp), ranks = world
    rows = reference[1]["cp/x"]
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["cp/all"],
                                      _compressed_psum_replay(rows[:dp * tp]))
        i = r // tp
        np.testing.assert_array_equal(
            got["cp/model"],
            _compressed_psum_replay(rows[i * tp:(i + 1) * tp]))
        s_max = max(np.abs(rows[:dp * tp]).max(), 1e-12) / 127.0
        dense = rows[:dp * tp].sum(0)
        assert np.abs(got["cp/all"] - dense).max() <= \
            dp * tp * s_max / 2 + 2.0 ** -22 * np.abs(dense).max()


def _host(leaf) -> np.ndarray:
    """A restored leaf as numpy: a bf16 CPU tensor as ml_dtypes' bf16."""
    if isinstance(leaf, torch.Tensor):
        return leaf.view(torch.uint16).numpy().view(jnp.bfloat16)
    return np.asarray(leaf)


def test_sharded_checkpoint_restores_elsewhere(world, reference):
    """Each world's Adafactor run saved at step 2 (whole leaves, one rank
    writing): the reference's ``restore`` and the port's single-device
    ``restore`` read the same bits, which lie within the trajectory
    tolerance of the reference's own state; restored on its own mesh
    (``convert.shard_cut``) it gives every rank its shards bit for bit
    and the writing rank the tree it wrote; the (2, 2) save restored on
    a (1, 2) mesh of two of its ranks does the same."""
    name, shape, ranks = world
    _, jstate = reference[2]["adafactor"]
    cdir = str(reference[1]["train/ckpt_dir"]) + "/" + "x".join(
        map(str, shape))
    step = ckpt.latest_step(cdir)
    assert step == W.TRAIN_STEPS
    from_ref, _ = jckpt.restore(cdir, step, jax.tree.map(jnp.asarray,
                                                         jstate))
    from_port, _ = ckpt.restore(cdir, step, jstate)
    for (path, a), (_, b), (_, c) in zip(
            jckpt._flatten_with_paths(jax.tree.map(np.asarray, from_ref)),
            ckpt.flatten_with_paths(from_port),
            jckpt._flatten_with_paths(jstate)):
        a, b = np.asarray(a), _host(b)
        assert a.tobytes() == b.tobytes(), path
        want = np.asarray(c).astype(np.float32)
        # Adafactor's bf16 momentum rounds at each step: two runs whose
        # float32 updates differ in the last bits may round an element a
        # few ulps apart, so it is held at one ulp of the leaf's largest
        atol = (2 ** -8 * float(np.abs(want).max())
                if a.dtype == jnp.bfloat16 else 1e-6)
        np.testing.assert_allclose(a.astype(np.float32), want, rtol=1e-4,
                                   atol=atol, err_msg=path)
    for got in ranks:       # the save restored on its own mesh
        assert got["convert/same"].all()
    if name == "2x2":
        for got in ranks[:2]:
            assert got["ckpt/elastic_same"].all()
            assert tuple(got["ckpt/elastic_local"]) == (
                W.DENSE["d_model"], W.DENSE["n_heads"] * W.DENSE["d_head"]
                // 2)
        assert all("ckpt/elastic_same" not in got for got in ranks[2:])


# -- the cells under a mesh ---------------------------------------------------


def _zero1_dim(whole_shape, n: int):
    """ZeRO-1's sharded dim of a leaf (``cells.py:146``): the first the
    device count divides, else None."""
    return next((i for i, d in enumerate(whole_shape) if d and d % n == 0),
                None)


@pytest.mark.parametrize("name", ["adafactor", "adamw"])
def test_zero1_train_steps_match_the_reference(world, reference, name):
    """ZeRO-1 under pure data parallelism over every axis: two steps from
    the reference's parameters on its batches (the trajectories' inputs)
    against its single-device ``make_train_step``: losses and norms rtol
    1e-5, the parameters (whole on every rank) rtol 1e-4, and each rank's
    optimizer-state shard against the rank's cut of the reference's state
    (each per-layer leaf sharded on its first dim the rank count divides:
    the stack's own dim never, since the port's leaves are per layer), a
    bf16 momentum within one ulp of the leaf's largest."""
    _, shape, ranks = world
    seen, jstate = reference[2][name]
    n = shape[0] * shape[1]
    ref_state = dict(jckpt._flatten_with_paths(jstate.opt_state))
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"zero1_{name}/metrics"], seen,
                                   rtol=1e-5)
        for key in got:
            if key.startswith(f"zero1_{name}/params/"):
                pname = key[len(f"zero1_{name}/params/"):]
                np.testing.assert_allclose(
                    got[key], _ref_of(jstate.params, pname), rtol=1e-4,
                    atol=1e-6, err_msg=pname)
        held = [k for k in got if k.startswith(f"zero1_{name}/state/")]
        assert len(held) == len(ref_state)
        for key in held:
            path = key[len(f"zero1_{name}/state/"):]
            want = np.asarray(ref_state[path])
            stacked = "layers/" in path and not (path.endswith("/c")
                                                 and want.ndim == 1)
            d0 = _zero1_dim(want.shape[1:] if stacked else want.shape, n)
            if d0 is not None:
                d0 += int(stacked)
                per = want.shape[d0] // n
                # rank r is flat mesh position r: the worlds' meshes are
                # built over ranks 0..n-1 in order
                want = np.take(want, range(r * per, (r + 1) * per), axis=d0)
            top = float(np.abs(want.astype(np.float32)).max()) or 1.0
            ulp = 2 ** -8 if want.dtype == jnp.bfloat16 else 1e-6
            np.testing.assert_allclose(got[key], want.astype(np.float32),
                                       rtol=1e-4, atol=ulp * top,
                                       err_msg=path)


@pytest.mark.parametrize("mode", ["allreduce", "dst_partitioned"])
def test_mesh_gat_loss_and_gradients_match_the_reference(world, reference,
                                                         mode):
    """GAT over the rank's edge shard, each aggregation: the loss (rtol
    1e-5) and every parameter's gradient, the ranks' shares summed by the
    trainer's rule (rtol 1e-4, atol 1e-6), against ``jax.value_and_grad``
    of the reference's ``loss_fn`` on one device. A share counted twice,
    or a sum's gradient not handed to each summand, would show as a factor
    of the rank count."""
    loss, grads = reference[2][f"gat_{mode}"]
    for got in world[2]:
        np.testing.assert_allclose(got[f"gat_{mode}/loss"], loss, rtol=1e-5)
        names = [k for k in got if k.startswith(f"gat_{mode}/grad/")]
        assert len(names) == 3 * len(grads["layers"])
        for key in names:
            _, i, leaf = key[len(f"gat_{mode}/grad/"):].split(".")
            np.testing.assert_allclose(got[key], grads["layers"][int(i)][leaf],
                                       rtol=1e-4, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("arch_id", W.RECSYS_TRAIN)
def test_mesh_recsys_loss_and_gradients_match_the_reference(world, reference,
                                                           arch_id):
    """A recsys model's training loss under the mesh, through the recsys
    cells' policy (``cells.recsys_mesh``: the batch over the data axes,
    the tables row-sharded over "model"): each rank's loss of its rows
    (rtol 1e-5) and every gradient, summed by the trainer's rule and the
    tables gathered whole (rtol 1e-4, atol 1e-6), against
    ``jax.value_and_grad`` of the reference's loss on the whole batch on
    one device. A gradient summed over "model", along which the ranks do
    the same work, would show as a factor of that axis's size; a global
    mean or a two-tower item gather off by the data ranks, as a factor
    of theirs."""
    loss, grads = reference[2][f"rs_{arch_id}"]
    pre = f"rs_{arch_id}/grad/"
    for got in world[2]:
        np.testing.assert_allclose(got[f"rs_{arch_id}/loss"], loss,
                                   rtol=1e-5)
        names = sorted(k[len(pre):] for k in got if k.startswith(pre))
        assert names == sorted(grads)
        for name in names:
            np.testing.assert_allclose(got[pre + name], grads[name],
                                       **GRAD_TOL, err_msg=name)


def _reference_two_tower(got, tag) -> dict:
    """The cell's towers, gathered whole by the ranks, as the reference's
    ``init_twotower_params`` tree."""
    def mlp(t):
        n = len([k for k in got if k.startswith(f"retr_{tag}/{t}/")
                 and k.endswith("/w")])
        return [{"w": jnp.asarray(got[f"retr_{tag}/{t}/{i}/w"]),
                 "b": jnp.asarray(got[f"retr_{tag}/{t}/{i}/b"])}
                for i in range(n)]
    return {"user_table": jnp.asarray(got[f"retr_{tag}/user_table"]),
            "item_table": jnp.asarray(got[f"retr_{tag}/item_table"]),
            "user_mlp": mlp("user_mlp"), "item_mlp": mlp("item_mlp")}


@pytest.mark.parametrize("tag", ["exact", "sah"])
def test_mesh_retrieval_cells_are_the_single_device_composition(world, tag):
    """The two-tower retrieval cells under the mesh (the exact cell and the
    SAH sketch cell, at the test's size: ``W.RETR_CAND`` candidates tiled
    as ``W.RETR_PAD`` rows, the rows past them dead), against the
    reference's single-device functions on the cell's inputs (its towers,
    features, candidates, codes and projection, gathered whole): the
    reference's ``user_tower``, then on each shard's rows the exact scores'
    ``lax.top_k`` (the reference cell's body) or the reference's
    ``kmips_flat_arrays`` without a mesh on ``ref.srp_hash``'s query code
    (``n_cand`` 512 a shard), the shards' winners merged by ``lax.top_k``
    as the reference's ``shard_map`` merges them. Every rank's ids equal
    the reference's; its values within float32 rounding of the two
    frameworks' products."""
    from repro.engine import sharding as jsharding
    from repro.kernels import ref as jref
    from repro_torch.launch import cells
    _, shape, ranks = world
    shards = shape[0] * shape[1]
    lead = ranks[0]
    jcfg = jbase.get("two-tower-retrieval").make_smoke_config()
    feats = jnp.asarray(lead[f"retr_{tag}/feats"])
    u = jrec.user_tower(_reference_two_tower(lead, tag), feats, jcfg)
    cand = jnp.asarray(lead[f"retr_{tag}/arg0"])
    assert cand.shape[0] == W.RETR_PAD
    per = cand.shape[0] // shards
    n = cells.N_RETRIEVE
    parts = []
    for s in range(shards):
        rows = slice(s * per, (s + 1) * per)
        ids = jnp.arange(s * per, (s + 1) * per, dtype=jnp.int32)
        if tag == "exact":
            sc = jnp.where(ids < W.RETR_CAND, cand[rows] @ u[0], -jnp.inf)
            v, p = jax.lax.top_k(sc, n)
            parts.append((v[None], ids[p][None]))
        else:
            codes = jnp.asarray(lead[f"retr_{tag}/arg1"].view(np.uint32))
            proj = jnp.asarray(lead[f"retr_{tag}/arg2"])
            parts.append(jsharding.kmips_flat_arrays(
                cand[rows], ids, jnp.ones(per, bool), codes[rows],
                jref.srp_hash(u, proj), u, n, JAX_NO_SHARDING, n_cand=512))
    best, pos = jax.lax.top_k(jnp.concatenate([v for v, _ in parts], 1), n)
    ids = jnp.take_along_axis(jnp.concatenate([i for _, i in parts], 1),
                              pos, axis=1)
    for got in ranks:
        np.testing.assert_array_equal(got[f"retr_{tag}/ids"],
                                      np.asarray(ids[0]))
        np.testing.assert_allclose(got[f"retr_{tag}/vals"],
                                   np.asarray(best[0]), rtol=1e-5)


class _Mesh:
    """A mesh stand-in for the reference's spec functions (they read
    ``shape`` and ``axis_names``)."""

    def __init__(self, shape):
        names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                            "model")
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _local(shape, spec, sizes: dict) -> tuple:
    out = list(shape)
    for d, entry in enumerate(tuple(spec)):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= sizes[a]
    return tuple(out)


def _spec_paths(specs) -> dict:
    """{path: PartitionSpec} of a spec tree, paths as the checkpoints'."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(jckpt._path_str(e) for e in path): spec
            for path, spec in flat}


def _reference_cell_specs(arch_id, sname, variant, shape) -> dict:
    """{path: the rank's shape} of the reference's cell (arch, shape) on a
    (data, model) mesh of ``shape``: its abstract shapes (``jax.
    eval_shape``) with its specs applied (``_lm_rules``, ``param_specs``,
    ``opt_state_specs``, ``_zero1_opt_specs``, ``_recsys_param_specs``,
    the batch and graph specs of ``build_*_cell``)."""
    mesh = _Mesh(shape)
    sizes = mesh.shape
    arch = jbase.get(arch_id)
    sh = arch.shape(sname)
    cfg = arch.make_config()
    dp = ("data",)
    out = {}

    def add(prefix, shapes, specs):
        sp = _spec_paths(specs)
        for path, leaf in jckpt._flatten_with_paths(shapes):
            if not path.endswith("length"):
                out["/".join(x for x in (prefix, path) if x)] = _local(
                    leaf.shape, sp[path], sizes)

    def train_state(params, opt):
        return jax.eval_shape(lambda p: jtrainer.TrainState(
            p, opt.init(p), jnp.zeros((), jnp.int32)), params)

    if arch.family == "lm":
        seq, batch = sh.dims["seq_len"], sh.dims["global_batch"]
        if sh.kind == "decode":
            cfg = dataclasses.replace(cfg, max_seq=seq)
        if variant == "zero1":
            rules = jax_lm_rules(dp, "model", pure_dp=True)
        else:
            rules = jcells._lm_rules(arch, sh.kind, mesh,
                                     long_ctx=sname.startswith("long"))
        pspecs = jtf.param_specs(cfg, JaxPolicy(rules=rules))
        params = jax.eval_shape(lambda k: jtf.init_params(k, cfg),
                                jax.random.PRNGKey(0))
        if sh.kind == "train":
            state = train_state(params, jcells.default_optimizer("lm"))
            if variant != "zero1":
                add("0", state, jtrainer.TrainState(
                    pspecs, jcells.opt_state_specs(state.opt_state, pspecs),
                    P()))
            else:
                add("0/.params", state.params, pspecs)
                out["0/.step"] = ()
                # the reference's function on one layer's leaves: the
                # port's leaves are per layer (the stack's dim is never
                # the sharded one), a 1-D stack's c whole
                per = {}
                for p, leaf in jckpt._flatten_with_paths(state.opt_state):
                    strip = "layers/" in p and not (p.endswith("/c")
                                                    and len(leaf.shape) == 1)
                    per[p] = (strip, leaf.shape, jax.ShapeDtypeStruct(
                        leaf.shape[int(strip):], leaf.dtype))
                specs = jcells._zero1_opt_specs(
                    {p: v[2] for p, v in per.items()}, mesh)
                for p, (strip, whole, leaf) in per.items():
                    loc = _local(leaf.shape, specs[p], sizes)
                    out[f"0/.opt_state/{p}"] = (whole[:1] + loc if strip
                                                else loc)
            tok = P(rules["act_btd"][0], None)
            for k in ("tokens", "labels"):
                out[f"1/{k}"] = _local((batch, seq), tok, sizes)
            return out
        add("0", params, pspecs)
        if sh.kind == "prefill":
            out["1"] = _local((batch, seq), P(dp, None), sizes)
            return out
        cache = jax.eval_shape(lambda: jtf.init_cache(cfg, batch))
        add("1", {"k": cache["k"], "v": cache["v"]},
            {"k": rules["kv_cache"], "v": rules["kv_cache"]})
        out["2"] = _local((batch,), P() if sname.startswith("long")
                          else P(dp), sizes)
        return out
    if arch.family == "gnn":
        dims = dict(sh.dims)
        if variant:
            dims["n_nodes"] = -(-dims["n_nodes"] // 512) * 512
        jc = dataclasses.replace(cfg, d_in=dims["d_feat"],
                                 n_classes=dims["n_classes"])
        params = jax.eval_shape(lambda k: jgat.init_params(k, jc),
                                jax.random.PRNGKey(0))
        state = train_state(params, jcells.default_optimizer())
        add("0", state, jax.tree.map(lambda _: P(), state))
        n, e = dims["n_nodes"], dims["n_edges"]
        out.update({"1/x": (n, dims["d_feat"]), "1/labels": (n,),
                    "1/label_mask": (n,)})
        for k in ("src", "dst", "edge_mask"):
            out[f"1/{k}"] = _local((e,), P(("data", "model")), sizes)
        return out
    # recsys
    init = {"deepfm": jrec.init_ctr_params,
            "two-tower-retrieval": jrec.init_twotower_params}[arch_id]
    tables = (("table",) if arch_id == "deepfm"
              else ("user_table", "item_table"))
    params = jax.eval_shape(lambda k: init(k, cfg,
                                           table_pad=sizes["model"]),
                            jax.random.PRNGKey(0))
    pspecs = jcells._recsys_param_specs(params, tables, mesh)
    if sh.kind == "train":
        state = train_state(params, jcells.default_optimizer())
        add("0", state, jtrainer.TrainState(
            pspecs, jcells.opt_state_specs(state.opt_state, pspecs), P()))
        bshape, bspec = jcells._recsys_batch(arch, cfg, sh.dims["batch"],
                                             dp)
        add("1", bshape, bspec)
        return out
    add("0", params, pspecs)
    out["1"] = (1, cfg.user_embedding.n_fields)
    out["2"] = _local((jcells.CAND_PAD, cfg.out_dim),
                      P(("data", "model"), None), sizes)
    return out


def test_specs_read_back_as_placements_and_local_shapes(world):
    """``cells._shardings`` and ``local_shapes`` of a recsys mesh cell's
    parameter rules: the placements read back as the rules, and the
    local shapes of the whole (padded) shapes are the rank's shards."""
    for got in world[2]:
        assert bool(got["specs/placed_ok"]) and bool(got["specs/local_ok"])


@pytest.mark.parametrize("arch_id,sname,variant", W.SPEC_CELLS)
def test_mesh_cells_hold_the_reference_specs_local_shapes(
        world, arch_id, sname, variant):
    """Each rank's ``build_cell(..., mesh=)`` abstract arguments, leaf for
    leaf, have the shapes the reference's specs give its abstract shapes
    on the same mesh (a stand-in for its ``Mesh``)."""
    _, shape, ranks = world
    want = _reference_cell_specs(arch_id, sname, variant, shape)
    prefix = f"spec/{arch_id}/{sname}/{variant}/"
    for got in ranks:
        mine = {k[len(prefix):]: tuple(v.tolist()) for k, v in got.items()
                if k.startswith(prefix)}
        assert mine == want


def test_cell_specs_as_data_match_the_reference():
    """The cells' specs as data, on the production meshes (stand-ins: the
    specs read only the axis names and sizes): ``_zero1_opt_specs`` of
    qwen3-0.6b's whole clip + Adafactor state and ``opt_state_specs``
    under the TP rules, path by path in the reference's nest (the port's
    layers stacked), and ``_recsys_param_specs`` of each recsys model
    against the reference's on its abstract shapes."""
    import math
    from repro_torch.launch import cells
    from repro_torch.train.trainer import init_state
    arch, jarch = base.get("qwen3-0.6b"), jbase.get("qwen3-0.6b")
    cfg, jcfg = arch.make_config(), jarch.make_config()
    model = tf.LM(cfg, "meta")
    state = init_state(dict(model.named_parameters()),
                       cells.default_optimizer("lm"))
    jparams = jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                             jax.random.PRNGKey(0))
    jopt = jcells.default_optimizer("lm")
    jstate = jax.eval_shape(lambda p: jtrainer.TrainState(
        p, jopt.init(p), jnp.zeros((), jnp.int32)), jparams)
    norm = lambda specs: {k: _norm(v) for k, v in specs.items()}  # noqa
    for shape in ((16, 16), (2, 16, 16)):
        jm = _Mesh(shape)
        names, n = jm.axis_names, math.prod(shape)
        pm = type("M", (), {"mesh_dim_names": names,
                            "size": lambda self, n=n: n})()
        got = cells._zero1_opt_specs(state, ShardingPolicy(mesh=pm))
        want = norm(_spec_paths(jcells._zero1_opt_specs(jstate, jm)))
        assert got == want, shape
        assert any(r for r in got.values())          # some leaf shards
        dp = names[:-1]
        pol = ShardingPolicy(mesh=pm, rules=lm_rules(dp, "model"))
        pol = pol.with_params(tf.param_rules(cfg, pol))
        got = cells.opt_state_specs(state, pol)
        want = norm(_spec_paths(jcells.opt_state_specs(
            jstate.opt_state, jtf.param_specs(jcfg, JaxPolicy(
                rules=jax_lm_rules(dp, "model"))))))
        assert got == want, shape
    for arch_id in ("deepfm", "din", "two-tower-retrieval"):
        jcfg = jbase.get(arch_id).make_smoke_config()
        cfg = base.get(arch_id).make_smoke_config()
        init = {"deepfm": jrec.init_ctr_params, "din": jrec.init_din_params,
                "two-tower-retrieval": jrec.init_twotower_params}[arch_id]
        jp = jax.eval_shape(lambda k: init(k, jcfg, table_pad=16),
                            jax.random.PRNGKey(0))
        model = recsys.model_for(cfg, "cpu")
        tables = recsys.TABLES[type(model).__name__]
        want = norm(_spec_paths(jcells._recsys_param_specs(jp, tables,
                                                           None)))
        got = {k.replace(".", "/"): v for k, v in
               cells._recsys_param_specs(model, tables).items()}
        assert got == want, arch_id

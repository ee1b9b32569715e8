"""The rank body of the gloo worlds that tests/test_torch_mp.py spawns:
the port's model-parallel serving paths (slice 16) and training (slice
17's training half) on the CPU.

JAX-free on purpose: ``torch.multiprocessing.spawn`` re-imports this module
in every rank, and a rank runs the port alone. The test writes the inputs
(the reference's parameters as numpy, tokens, tables, candidates) to one
``inputs.npz``; each world is spawned once (``spawn_world``); every rank
runs ``rank_checks`` under its ("data", "model") mesh and writes what it
saw, gathered to whole tensors, to ``rank<r>.npz``, which the test holds
against the reference and the single-device port.
"""

from __future__ import annotations

import datetime
import math
import os

import numpy as np
import torch

# world name -> ("data", "model") mesh shape
WORLDS = {"1x2": (1, 2), "2x2": (2, 2)}
GROUP_TIMEOUT = 60       # seconds a collective may wait
SEED = 11

# the dense LM: the reference test's config (tests/test_distributed.py)
# with qk-norm and QKV biases on, so the rank's slices of both are used
DENSE = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
             d_head=8, d_ff=64, vocab=128, attn_chunk=16, qk_norm=True,
             qkv_bias=True)
MOE = dict(n_experts=8, top_k=2, d_ff_expert=16)
PROMPT = (4, 32)         # prefill tokens (B, S): S shards over "model"
N_DECODE = 4             # decode steps, each rule set
MAX_SEQ = 36             # S + N_DECODE: divides over 2 and 4 ranks
MOE_PROMPT = (4, 16)
MOE_DECODE = 2
EP_TOKENS = (4, 8, 16)   # (B, S, D) of the standalone EP checks
TT_CAND = 600            # two-tower candidates; n_cand < a shard's rows
TT_USERS = 6
TT_NCAND, TT_K = 64, 10
# training: the global batch (B, S) of a step (B a multiple of 8 and
# TRAIN_LOSS_CHUNK < B * S, so the loss runs in 8 checkpointed chunks),
# the steps of a trajectory, the learning rates
TRAIN_BATCH = (16, 16)
TRAIN_LOSS_CHUNK = 64
TRAIN_STEPS = 2
ADAMW = dict(lr=1e-3, eps=1e-6)
SGD_LR = 0.1
CP_SHAPE = (4, 64)       # compressed_psum: one row a rank, by mesh position
# the rules whose placements are held against the reference: lm_rules
# (both sets), and _lm_rules' prefill (tp_heads and not), decode and
# long-context decode sets
RULE_SETS = ("tp", "pure_dp", "prefill", "prefill_no_tp_heads", "decode",
             "long_ctx")


def dense_config(**kw):
    from repro_torch.models.transformer import LMConfig
    return LMConfig(**{**DENSE, "dtype": torch.float32, "max_seq": MAX_SEQ,
                       **kw})


def moe_lm_config():
    """olmoe-smoke (2 layers, 8 experts top-2) at a capacity factor where
    nothing drops (E / k: capacity = the tokens), so the per-shard
    capacity of expert parallelism changes no answer."""
    import dataclasses as dc
    from repro_torch.configs import base
    cfg = base.get("olmoe-1b-7b").make_smoke_config()
    return dc.replace(cfg, max_seq=MOE_PROMPT[1] + MOE_DECODE,
                      moe=dc.replace(cfg.moe, capacity_factor=float(
                          cfg.moe.n_experts // cfg.moe.top_k)))


def moe_config(capacity_factor: float):
    from repro_torch.models import moe
    return moe.MoEConfig(**MOE, capacity_factor=capacity_factor)


def rule_set(name: str, mesh) -> dict:
    from repro_torch.configs import base
    from repro_torch.dist import lm_rules
    from repro_torch.launch import cells
    if name in ("tp", "pure_dp"):
        return lm_rules(("data",), "model", pure_dp=name == "pure_dp")
    arch = base.get("qwen2-1.5b" if name == "prefill_no_tp_heads"
                    else "qwen3-0.6b")
    kind = "prefill" if name.startswith("prefill") else "decode"
    return cells._lm_rules(arch, kind, mesh, long_ctx=name == "long_ctx")


def unflatten(flat: dict, prefix: str) -> dict:
    """The nest {a: {b: leaf}} of the keys ``prefix/a/b`` of ``flat``."""
    tree = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        *path, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def spec_of(placements, names, ndim) -> tuple:
    """Placements back to a rule in ``tuple(PartitionSpec)``'s form."""
    from torch.distributed.tensor import Shard
    out = []
    for d in range(ndim):
        axes = tuple(n for n, pl in zip(names, placements)
                     if isinstance(pl, Shard) and pl.dim == d)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    return tuple(out)


def raises(exc, fn) -> str:
    """The message of the ``exc`` that ``fn()`` raises ('' if none)."""
    try:
        fn()
    except exc as e:  # noqa: PERF203
        return str(e)
    return ""


def rank_checks(shape: tuple, inputs: dict) -> dict:
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.dist import ShardingPolicy, collectives as coll
    from repro_torch.launch import serve
    from repro_torch.models import convert, embedding, moe, recsys
    from repro_torch.models import transformer as tf

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {}
    sets = {name: rule_set(name, mesh) for name in RULE_SETS}
    pol = {name: ShardingPolicy(mesh=mesh, rules=rules)
           for name, rules in sets.items()}

    # -- the rules as placements ------------------------------------------
    for name, rules in sets.items():
        for rule, spec in rules.items():
            got = spec_of(pol[name].sharding(rule), mesh.mesh_dim_names,
                          len(spec))
            out[f"rules/{name}/{rule}"] = np.array(repr(got))

    # -- relayout round trips and all_to_all -------------------------------
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(4, 8, 6, generator=gen)
    tp = pol["tp"]
    ok = []
    for a, b in ((("data", "model", None), (None, "model", None)),
                 ((("data", "model"), None, None), (None, None, "model")),
                 (("model", None, None), ("data", "model", None))):
        xa, xb = tp.relayout(x, (), a), tp.relayout(x, (), b)
        ok.append(torch.equal(tp.relayout(xa, a, ()), x))
        ok.append(torch.equal(tp.relayout(xa, a, b), xb))
    # partial sums: each rank's share, reduce-scattered onto the sequence
    share = torch.randn(4, 8, 6, generator=torch.Generator().manual_seed(
        SEED + tp.axis_index(("data", "model"))))
    total = coll.psum(share, tp, ("data", "model"))
    ok.append(torch.allclose(
        tp.relayout(share, ("data", None, None), "act_btd",
                    partial=("model",)),
        tp.relayout(coll.psum(share, tp, "model"), ("data", None, None),
                    "act_btd"),
        rtol=0, atol=1e-6))
    ok.append(torch.allclose(tp.relayout(total, (), ()),
                             sum(torch.randn(4, 8, 6,
                                             generator=torch.Generator()
                                             .manual_seed(SEED + r))
                                 for r in range(mesh.size())), atol=1e-5))
    out["relayout/ok"] = np.array(ok)
    me = tp.axis_index("model")
    n = tp.model_axis_size
    t = torch.arange(n * 3 * 2 * n, dtype=torch.float32).reshape(
        n * 3, 2 * n) + 1000 * me
    got = coll.all_to_all(t, tp, "model", split_axis=0, concat_axis=1)
    want = torch.cat([(torch.arange(n * 3 * 2 * n, dtype=torch.float32)
                       .reshape(n * 3, 2 * n) + 1000 * c)[me * 3:(me + 1) * 3]
                      for c in range(n)], dim=1)
    out["a2a/ok"] = np.array(torch.equal(got, want))
    out["pmax"] = coll.pmax(torch.tensor([float(me)]), tp, "model").numpy()

    # -- the refusals -----------------------------------------------------
    out["refuse/constrain"] = np.array(raises(
        TypeError, lambda: tp.constrain(x, "act_btd")))
    out["refuse/indivisible"] = np.array(raises(
        ValueError, lambda: tf.init_params(
            dense_config(vocab=127), torch.Generator().manual_seed(0),
            "cpu", policy=tp)))
    out["refuse/order"] = np.array(raises(ValueError, lambda: ShardingPolicy(
        mesh=mesh, rules={"r": (("model", "data"),)}).sharding("r")))
    # the shard init_params draws equals shard_lm of the whole model
    whole = tf.init_params(dense_config(), torch.Generator().manual_seed(3),
                           "cpu")
    part = tf.init_params(dense_config(), torch.Generator().manual_seed(3),
                          "cpu", policy=tp)
    cut = dict(tf.shard_lm(whole, tp).named_parameters())
    out["init/same"] = np.array(all(torch.equal(p, cut[name]) for name, p
                                    in part.named_parameters()))

    # -- calls the ranks disagree on: every rank raises, none waits -------
    ppol, dpol = pol["prefill"], pol["decode"]
    shard = tf.shard_lm(whole, ppol)
    lm_tokens = torch.from_numpy(inputs["lm/tokens"]).long()
    tok = ppol.relayout(lm_tokens, (), (ppol.rules["act_btd"][0], None))
    out["refuse/tokens"] = np.array(raises(ValueError, lambda: tf.prefill(
        shard, (tok + int(me == 1)) % DENSE["vocab"], ppol)))
    out["refuse/shard"] = np.array(raises(ValueError, lambda: tf.prefill(
        whole if me == 0 else shard, tok, ppol)))
    cache = tf.relayout_cache(tf.prefill(shard, tok, ppol)[1], ppol, dpol)
    cache["length"] += int(me == 1)
    out["refuse/step"] = np.array(raises(ValueError, lambda: tf.decode_step(
        shard, cache, dpol.relayout(lm_tokens[:, 0], (),
                                    (dpol.rules["act_btd"][0],)), dpol)))

    # -- the row-sharded embedding_bag ------------------------------------
    table_l = embedding.shard_rows(torch.from_numpy(inputs["emb/table"]),
                                   tp)
    out["emb/out"] = embedding.embedding_bag(
        table_l, torch.from_numpy(inputs["emb/rows"]).long(), tp).numpy()

    # -- expert parallelism: tokens in act_btd, the rank's experts --------
    moe_p = unflatten(inputs, "moe/params")
    for cf in (1.25, 8.0):
        cfg = moe_config(cf)
        m = moe.MoE(EP_TOKENS[2], cfg, torch.float32, "cpu")
        with torch.no_grad():
            m.router.copy_(torch.from_numpy(moe_p["router"]))
            for w in ("w_in", "w_gate", "w_out"):
                full = torch.from_numpy(moe_p[w])
                setattr(m, w, torch.nn.Parameter(
                    tp.relayout(full, (), ("model", None, None)).clone()))
            x_l = tp.relayout(torch.from_numpy(inputs["moe/x"]), (),
                              "act_btd")
            stats = {}
            o, aux = moe.moe_ffn(x_l, m, cfg, tp, stats=stats)
        out[f"moe{cf}/out"] = tp.relayout(o, "act_btd", ()).numpy()
        out[f"moe{cf}/aux"] = aux.numpy()
        out[f"moe{cf}/dropped"] = np.array(int(stats["dropped"]))

    # -- the dense LM: TP/SP prefill, then split-KV decode ----------------
    tree = unflatten(inputs, "lm/params")
    cfg = dense_config(attn_impl="flash")
    tokens = torch.from_numpy(inputs["lm/tokens"]).long()
    teach = torch.from_numpy(inputs["lm/teach"]).long()      # (steps, B)

    def lm_run(prefix, cfg, tree, tokens, teach, pname, dnames):
        ppol = pol[pname]
        model = convert.params_from_jax(tree, cfg, "cpu", policy=ppol)
        tok_l = ppol.relayout(tokens, (), (ppol.rules["act_btd"][0], None))
        logits, cache = tf.prefill(model, tok_l, ppol)
        out[f"{prefix}/logits"] = ppol.relayout(
            logits, (ppol.rules["logits"][0], ppol.rules["logits"][2]),
            ()).numpy()
        for name in ("k", "v"):
            out[f"{prefix}/cache_{name}"] = ppol.relayout(
                cache[name], "kv_cache", ()).numpy()
        first = tf.greedy(logits, ppol)
        out[f"{prefix}/greedy0"] = ppol.relayout(
            first, (ppol.rules["act_btd"][0],), ()).numpy()
        for dname in dnames:
            dpol = pol[dname]
            c = tf.relayout_cache(cache, ppol, dpol)
            batch = (dpol.rules["act_btd"][0],)
            lg, gr = [], []
            for step in range(teach.shape[0]):
                step_logits, c = tf.decode_step(
                    model, c, dpol.relayout(teach[step], (), batch), dpol)
                lg.append(dpol.relayout(step_logits,
                                        (dpol.rules["logits"][0],
                                         dpol.rules["logits"][2]), ()))
                gr.append(dpol.relayout(tf.greedy(step_logits, dpol),
                                        batch, ()))
            out[f"{prefix}/{dname}/logits"] = torch.stack(lg).numpy()
            out[f"{prefix}/{dname}/greedy"] = torch.stack(gr).numpy()
            out[f"{prefix}/{dname}/length"] = np.array(c["length"])

    lm_run("lm", cfg, tree, tokens, teach, "prefill", ("decode", "long_ctx"))
    lm_run("lm_heads", dense_config(), tree, tokens, teach[:0],
           "prefill_no_tp_heads", ())
    lm_run("moe_lm", moe_lm_config(), unflatten(inputs, "moe_lm/params"),
           torch.from_numpy(inputs["moe_lm/tokens"]).long(),
           torch.from_numpy(inputs["moe_lm/teach"]).long(), "prefill",
           ("decode",))

    # -- two-tower retrieval over row-sharded tables ----------------------
    from repro_torch.configs import base
    tcfg = base.get("two-tower-retrieval").make_smoke_config()
    model = convert.recsys_params_from_jax(unflatten(inputs, "tt/params"),
                                           tcfg, "cpu", policy=tp)
    out["tt/table_rows"] = np.array(model.user_table.shape[0])
    # the rank's equal slice of the candidates, in mesh order
    from repro_torch.dist.policy import shard_rank
    per = TT_CAND // tp.device_count
    mine = slice(shard_rank(tp) * per, (shard_rank(tp) + 1) * per)
    cand = torch.from_numpy(inputs["tt/cand"])[mine]
    codes = torch.from_numpy(inputs["tt/codes"])[mine]
    proj = torch.from_numpy(inputs["tt/proj"])
    users = torch.from_numpy(inputs["tt/users"]).long()
    us, ids, vals = [], [], []
    with torch.no_grad():
        for i in range(users.shape[0]):
            us.append(recsys.user_tower(model, users[i:i + 1], tcfg, tp)[0])
            v, d = serve.sah_retrieve_step(model, users[i:i + 1], cand,
                                           codes, proj, tcfg, tp,
                                           n_cand=TT_NCAND, k=TT_K)
            vals.append(v)
            ids.append(d)
    out["tt/u"] = torch.stack(us).numpy()
    out["tt/ids"] = torch.stack(ids).numpy()
    out["tt/vals"] = torch.stack(vals).numpy()
    out.update(train_checks(shape, mesh, inputs))
    out.update(cells_checks(shape, mesh, inputs))
    return out


def train_rules(arch: str, mesh) -> dict:
    from repro_torch.configs import base
    from repro_torch.launch import cells
    return cells._lm_rules(base.get(arch), "train", mesh)


def train_config(**kw):
    """The trajectories' LM: the dense config without QKV biases (a K
    bias shifts a whole softmax row, so its true gradient is 0 and an
    optimizer step turns its rounding noise into a full-size update)."""
    return dense_config(qkv_bias=False, **kw)


def local_batch(pol, tokens) -> dict:
    """The rank's batch of a global (B, S + 1) token array: tokens and
    labels shifted by one, the rows of its data coordinate."""
    seqs = torch.from_numpy(tokens).long()
    rows = (pol.rules["act_btd"][0], None)
    return {"tokens": pol.relayout(seqs[:, :-1], (), rows).contiguous(),
            "labels": pol.relayout(seqs[:, 1:], (), rows).contiguous()}


def whole(pol, tensors: dict, prefix: str) -> dict:
    """Each rank-local parameter-keyed tensor gathered whole (by the
    parameter rules ``pol`` carries), keyed ``prefix/name``."""
    return {f"{prefix}/{n}": pol.relayout(t.detach(), pol.param_rule(n),
                                          ()).numpy()
            for n, t in tensors.items()}


def train_checks(shape: tuple, mesh, inputs: dict) -> dict:
    """Slice 17's training half on this rank: lm_loss and its reduced
    gradients (both head layouts, the MoE LM), trajectories of
    clip + Adafactor and clip + AdamW, grad_accum, EP's backward,
    compressed_psum, and the sharded checkpoint with its elastic
    restore. Every tensor is gathered whole for the test."""
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.dist import ShardingPolicy
    from repro_torch.launch import cells
    from repro_torch.models import convert, moe
    from repro_torch.models import transformer as tf
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import compression
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer

    out = {}
    pol = {arch: ShardingPolicy(mesh=mesh, rules=train_rules(arch, mesh))
           for arch in ("qwen3-0.6b", "qwen2-1.5b")}

    # -- lm_loss and every reduced gradient --------------------------------
    moe_cfg = dataclasses.replace(moe_lm_config(), aux_loss_weight=0.0)
    for prefix, cfg, params, arch in (
            ("grad_lm", dense_config(), "lm/params", "qwen3-0.6b"),
            ("grad_lm_heads", dense_config(), "lm/params", "qwen2-1.5b"),
            ("grad_moe_lm", moe_cfg, "moe_lm/params", "qwen3-0.6b")):
        p = pol[arch]
        p = p.with_params(tf.param_rules(cfg, p))
        model = convert.params_from_jax(unflatten(inputs, params), cfg,
                                        "cpu", policy=p)
        tokens = inputs["train/moe_tokens" if "moe" in prefix
                        else "train/tokens"][0]
        loss = tf.lm_loss(model, local_batch(p, tokens), p,
                          loss_chunk=TRAIN_LOSS_CHUNK)
        named = dict(model.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))
        grads = trainer.reduce_grads(grads, p)
        out[f"{prefix}/loss"] = loss.detach().numpy()
        out.update(whole(p, grads, prefix))

    # -- trajectories: clip + Adafactor (the cells' LM optimizer), clip +
    # AdamW; the Adafactor run through train_loop, checkpointed -----------
    cfg = train_config()
    p = pol["qwen3-0.6b"].with_params(tf.param_rules(cfg, pol["qwen3-0.6b"]))
    tree = unflatten(inputs, "train/params")
    batches = [local_batch(p, t) for t in inputs["train/tokens"]]
    ckpt_dir = os.path.join(str(inputs["train/ckpt_dir"]),
                            "x".join(map(str, shape)))

    def loss_fn(model):
        return lambda params, b: tf.lm_loss(model, b, p,
                                            loss_chunk=TRAIN_LOSS_CHUNK)

    def run(name, optimizer, n_batches, grad_accum=1, **loop):
        model = convert.params_from_jax(tree, cfg, "cpu", policy=p)
        params = dict(model.named_parameters())
        step = trainer.make_train_step(loss_fn(model), optimizer,
                                       grad_accum=grad_accum, policy=p)
        seen = []

        def recorded(state, batch):
            state, m = step(state, batch)
            seen.append((float(m["loss"]), float(m["grad_norm"])))
            return state, m

        state = trainer.train_loop(
            trainer.init_state(params, optimizer), recorded,
            iter(batches[:n_batches]), n_steps=n_batches, log_every=10 ** 9,
            log_fn=lambda _: None, policy=p, **loop)
        out[f"{name}/metrics"] = np.array(seen)
        out.update(whole(p, params, f"{name}/params"))
        return state, optimizer

    ada = cells.default_optimizer("lm", policy=p)
    state, _ = run("adafactor", ada, TRAIN_STEPS, ckpt_dir=ckpt_dir,
                   ckpt_every=TRAIN_STEPS)
    mine = ckpt.flatten_with_paths(convert.train_state_to_numpy(state))
    saved = convert.train_state_to_numpy(state, p)   # None but on rank 0
    # the save restored into a fresh state's shards on the same mesh: each
    # rank's shards bit for bit its own, and on the writing rank the
    # whole tree gathered again bit for bit the one it wrote
    fresh = trainer.init_state(dict(convert.params_from_jax(
        tree, cfg, "cpu", policy=p).named_parameters()), ada)
    got, _ = ckpt.restore(ckpt_dir, ckpt.latest_step(ckpt_dir),
                          convert.train_state_to_numpy(fresh),
                          cut=convert.shard_cut(fresh, p))
    convert.train_state_from_jax(got, fresh)
    same = [_bytes(a) == _bytes(b) for (_, a), (_, b) in zip(
        ckpt.flatten_with_paths(convert.train_state_to_numpy(fresh)), mine)]
    back = convert.train_state_to_numpy(fresh, p)
    if saved is not None:
        same += [_bytes(a) == _bytes(b) for (_, a), (_, b) in zip(
            ckpt.flatten_with_paths(back), ckpt.flatten_with_paths(saved))]
    out["convert/same"] = np.array(same)
    run("adamw", opt_lib.chain(
        opt_lib.clip_by_global_norm(1.0, policy=p),
        opt_lib.adamw(ADAMW["lr"], eps=ADAMW["eps"])), TRAIN_STEPS)
    for accum in (1, 2):
        run(f"accum{accum}", opt_lib.sgd(SGD_LR), 1, grad_accum=accum)

    # -- the checkpoint restored on a (1, 2) mesh of ranks 0 and 1 ---------
    sub = DeviceMesh("cpu", [[0, 1]], mesh_dim_names=("data", "model"))
    if sub.get_coordinate() is not None:
        sp = ShardingPolicy(mesh=sub, rules=train_rules("qwen3-0.6b", sub))
        sp = sp.with_params(tf.param_rules(cfg, sp))
        model = convert.params_from_jax(tree, cfg, "cpu", policy=sp)
        opt = cells.default_optimizer("lm", policy=sp)
        fresh = trainer.init_state(dict(model.named_parameters()), opt)
        got, _ = ckpt.restore(ckpt_dir, ckpt.latest_step(ckpt_dir),
                              convert.train_state_to_numpy(fresh),
                              cut=convert.shard_cut(fresh, sp))
        convert.train_state_from_jax(got, fresh)
        # ranks 0 and 1 hold the same chunks on (1, 2) as on (2, 2)
        same = [_bytes(a) == _bytes(b) for (_, a), (_, b) in zip(
            ckpt.flatten_with_paths(convert.train_state_to_numpy(fresh)),
            mine)]
        back = convert.train_state_to_numpy(fresh, sp)
        if back is not None:
            same += [_bytes(a) == _bytes(b) for (_, a), (_, b) in zip(
                ckpt.flatten_with_paths(back),
                ckpt.flatten_with_paths(saved))]
        out["ckpt/elastic_same"] = np.array(same)
        out["ckpt/elastic_local"] = np.array(
            tuple(fresh.params["blocks.0.wq"].shape))
    dist.barrier()

    # -- EP's backward at capacity factor 1.25 (experts overflow) ----------
    tp = ShardingPolicy(mesh=mesh, rules=rule_set("tp", mesh))
    mcfg = moe_config(1.25)
    moe_p = unflatten(inputs, "moe/params")
    m = moe.MoE(EP_TOKENS[2], mcfg, torch.float32, "cpu")
    with torch.no_grad():
        m.router.copy_(torch.from_numpy(moe_p["router"]))
        for w in ("w_in", "w_gate", "w_out"):
            setattr(m, w, torch.nn.Parameter(tp.relayout(
                torch.from_numpy(moe_p[w]), (), ("model", None, None))
                .clone()))
    x_l = tp.relayout(torch.from_numpy(inputs["moe/x"]), (), "act_btd")
    x_l.requires_grad_(True)
    cot = tp.relayout(torch.from_numpy(inputs["moe/cot"]), (), "act_btd")
    stats = {}
    o, aux = moe.moe_ffn(x_l, m, mcfg, tp, stats=stats)
    objective = (o * cot).sum() + float(inputs["moe/aux_weight"]) * aux
    named = dict(m.named_parameters())
    grads = torch.autograd.grad(objective, [x_l, *named.values()])
    tp = tp.with_params({"router": (), "w_in": ("model",),
                         "w_gate": ("model",), "w_out": ("model",)})
    reduced = trainer.reduce_grads(dict(zip(named, grads[1:])), tp)
    out.update(whole(tp, reduced, "ep/grad"))
    out["ep/grad/x"] = tp.relayout(grads[0], "act_btd", ()).numpy()
    out["ep/dropped"] = np.array(int(stats["dropped"]))

    # -- compressed_psum over every axis and over "model" ------------------
    row = torch.from_numpy(inputs["cp/x"][p.axis_index(("data", "model"))])
    out["cp/all"] = compression.compressed_psum(row, p,
                                                ("data", "model")).numpy()
    out["cp/model"] = compression.compressed_psum(row, p, "model").numpy()
    return out


# -- the cells under a mesh -------------------------------------------------

# the GAT checks' graph: N nodes, E edges in GAT_BLOCKS owner blocks (a
# dst-partitioned graph for any world of up to GAT_BLOCKS ranks)
GAT_GRAPH = dict(n=64, e=256, blocks=4)
RETR_CAND = 3000         # the retrieval cells' candidates (the test's size)
RETR_PAD = 4096          # ... tiled over the ranks (CAND_PAD's stand-in)
# the recsys archs whose loss and reduced gradients under the mesh the
# test holds against the reference's single-device ones, on a global
# batch of RECSYS_BATCH rows split over the data axes
RECSYS_TRAIN = ("deepfm", "din", "two-tower-retrieval")
RECSYS_BATCH = 16
# the cells whose rank-local abstract shapes the test holds against the
# reference's specs: (arch, shape, variant)
SPEC_CELLS = (("qwen3-0.6b", "train_4k", ""), ("qwen3-0.6b", "train_4k",
                                                 "zero1"),
              ("qwen3-0.6b", "prefill_32k", ""),
              ("qwen3-0.6b", "decode_32k", ""),
              ("qwen3-0.6b", "long_500k", ""),
              ("olmoe-1b-7b", "train_4k", ""),
              ("gat-cora", "ogb_products", ""),
              ("gat-cora", "ogb_products", "dst_partitioned"),
              ("deepfm", "train_batch", ""),
              ("two-tower-retrieval", "train_batch", ""),
              ("two-tower-retrieval", "retrieval_cand", ""))


def gat_config(agg_mode: str = "allreduce"):
    import dataclasses as dc
    from repro_torch.configs import base
    return dc.replace(base.get("gat-cora").make_smoke_config(),
                      agg_mode=agg_mode)


def abstract_shapes(cell) -> dict:
    """{reference path: shape} of a cell's abstract arguments, the model's
    parameters standing for the params pytree (``tests/
    test_torch_cells.py::_port_layout``)."""
    from repro_torch.models import convert
    from repro_torch.train import checkpoint as ckpt
    model, *rest = cell.abstract_args
    names = set(dict(model.named_parameters()))
    args = tuple(rest) if cell.kind == "train" else (
        dict(model.named_parameters()), *rest)
    tree = convert.reference_layout(args, names)
    return {p: tuple(t.shape) for p, t in ckpt.flatten_with_paths(tree)
            if isinstance(t, torch.Tensor)}


class smoke_registry:
    """``configs.base.get`` answering each arch with its smoke config as
    ``make_config``, and ``cells.CAND_PAD`` at ``RETR_PAD``, inside the
    block: the retrieval cells at the test's size."""

    def __enter__(self):
        import dataclasses as dc
        from repro_torch.configs import base
        from repro_torch.launch import cells
        self.saved = base.get, cells.CAND_PAD
        real = base.get
        base.get = lambda a: dc.replace(real(a),
                                        make_config=real(a).make_smoke_config)
        cells.CAND_PAD = RETR_PAD
        return self

    def __exit__(self, *exc):
        from repro_torch.configs import base
        from repro_torch.launch import cells
        base.get, cells.CAND_PAD = self.saved


def cells_checks(shape: tuple, mesh, inputs: dict) -> dict:
    """The cells under a mesh on this rank: ZeRO-1 trajectories, GAT's
    two aggregations with their gradients, the recsys losses with their
    reduced gradients, the retrieval cells' answers, and the rank-local
    shapes of ``build_cell(mesh=)``."""
    import dataclasses
    from repro_torch.configs import base
    from repro_torch.dist import ShardingPolicy, lm_rules
    from repro_torch.launch import cells, serve
    from repro_torch.models import convert, gat
    from repro_torch.models import transformer as tf
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train import trainer

    out = {}
    axes = tuple(mesh.mesh_dim_names)

    # -- ZeRO-1: pure data parallelism, the state sharded ------------------
    cfg = train_config()
    pol = ShardingPolicy(mesh=mesh, rules=lm_rules(("data",), "model",
                                                   pure_dp=True))
    pol = pol.with_params(tf.param_rules(cfg, pol))
    tree = unflatten(inputs, "train/params")
    batches = [local_batch(pol, t) for t in inputs["train/tokens"]]
    for name in ("adafactor", "adamw"):
        model = convert.params_from_jax(tree, cfg, "cpu", policy=pol)
        params = dict(model.named_parameters())
        zpol = pol.with_params(opt_lib.zero1_rules(params, pol))
        inner = (cells.default_optimizer("lm", policy=zpol)
                 if name == "adafactor" else opt_lib.chain(
                     opt_lib.clip_by_global_norm(1.0, policy=zpol),
                     opt_lib.adamw(ADAMW["lr"], eps=ADAMW["eps"])))
        opt = opt_lib.zero1(inner, zpol)
        step = trainer.make_train_step(
            lambda p, b, m=model: tf.lm_loss(m, b, pol,
                                             loss_chunk=TRAIN_LOSS_CHUNK),
            opt, policy=pol)
        state = trainer.init_state(params, opt)
        seen = []
        for batch in batches:
            state, m = step(state, batch)
            seen.append((float(m["loss"]), float(m["grad_norm"])))
        out[f"zero1_{name}/metrics"] = np.array(seen)
        out.update({f"zero1_{name}/params/{k}": v.detach().numpy()
                    for k, v in params.items()})
        local = convert.train_state_to_numpy(state)
        from repro_torch.train import checkpoint as ckpt
        for path, leaf in ckpt.flatten_with_paths(local.opt_state):
            out[f"zero1_{name}/state/{path}"] = _f32(leaf)

    # -- GAT: both aggregations over the rank's edge shard -----------------
    gparams = unflatten(inputs, "gat/params")
    n_dev, me = mesh.size(), pol.axis_index(axes)
    for mode in ("allreduce", "dst_partitioned"):
        gcfg = gat_config(mode)
        model = convert.gat_params_from_jax(gparams, gcfg, "cpu")
        gpol = ShardingPolicy(mesh=mesh, rules={}).with_params(
            {k: () for k, _ in model.named_parameters()})
        graph = {k[len(f"gat/{mode}/"):]: torch.from_numpy(v)
                 for k, v in inputs.items() if k.startswith(f"gat/{mode}/")}
        per = graph["src"].shape[0] // n_dev
        for k in ("src", "dst", "edge_mask"):
            graph[k] = graph[k][me * per:(me + 1) * per]
        loss = gat.loss_fn(model, graph, gcfg, gpol)
        named = dict(model.named_parameters())
        grads = trainer.reduce_grads(dict(zip(named, torch.autograd.grad(
            loss, list(named.values())))), gpol)
        out[f"gat_{mode}/loss"] = loss.detach().numpy()
        out.update({f"gat_{mode}/grad/{k}": g.numpy()
                    for k, g in grads.items()})

    # -- recsys training: the rank's rows of the batch, its table rows ----
    for arch_id in RECSYS_TRAIN:
        arch = base.get(arch_id)
        rcfg = arch.make_smoke_config()
        rpol = cells.recsys_mesh(arch, rcfg, mesh)[0]
        model = convert.recsys_params_from_jax(
            unflatten(inputs, f"rs/{arch_id}/params"), rcfg, "cpu",
            policy=rpol)
        pre = f"rs/{arch_id}/batch/"
        batch = {k[len(pre):]: cells._rows(rpol, torch.from_numpy(v),
                                           rpol.dp_axes())
                 for k, v in inputs.items() if k.startswith(pre)}
        loss = cells.recsys_fns(arch, rcfg, rpol)[1](model, batch)
        named = dict(model.named_parameters())
        grads = trainer.reduce_grads(dict(zip(named, torch.autograd.grad(
            loss, list(named.values())))), rpol)
        out[f"rs_{arch_id}/loss"] = loss.detach().numpy()
        out.update({f"rs_{arch_id}/grad/{k}": rpol.relayout(
            g, rpol.param_rule(k), ()).numpy() for k, g in grads.items()})

    # -- the retrieval cells at the test's size ------------------------------
    with smoke_registry():
        arch = base.get("two-tower-retrieval")
        rshape = base.ShapeSpec("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": RETR_CAND})
        for tag, cell in (("exact", cells.build_recsys_cell(arch, rshape,
                                                            mesh=mesh)),
                          ("sah", serve.build_sah_retrieval_cell(
                              mesh=mesh))):
            args = cells.materialize(cell, "cpu",
                                     torch.Generator().manual_seed(SEED))
            vals, ids = cell.step(*args)
            out[f"retr_{tag}/vals"] = vals.numpy()
            out[f"retr_{tag}/ids"] = ids.numpy()
            cp = cell.policy
            model = args[0]
            for t in ("user_table", "item_table"):
                out[f"retr_{tag}/{t}"] = cp.relayout(
                    getattr(model, t).detach(), (("model",), None),
                    ()).numpy()
            for t in ("user_mlp", "item_mlp"):
                for i, layer in enumerate(getattr(model, t)):
                    out[f"retr_{tag}/{t}/{i}/w"] = layer.w.detach().numpy()
                    out[f"retr_{tag}/{t}/{i}/b"] = layer.b.detach().numpy()
            out[f"retr_{tag}/feats"] = args[1].numpy()
            for i, a in enumerate(args[2:]):
                if a.shape[0] * n_dev == cells.CAND_PAD:   # row shards
                    a = cp.relayout(a, (axes,) + (None,) * (a.dim() - 1),
                                    ())
                out[f"retr_{tag}/arg{i}"] = a.numpy()

    # -- build_cell(mesh=): each rank's abstract shapes --------------------
    for arch_id, sname, variant in SPEC_CELLS:
        cell = cells.build_cell(arch_id, sname, mesh=mesh, variant=variant)
        for path, shp in abstract_shapes(cell).items():
            out[f"spec/{arch_id}/{sname}/{variant}/{path}"] = np.array(shp)

    # -- the specs as placements and local shapes (a recsys cell's) --------
    cell = cells.build_cell("deepfm", "train_batch", mesh=mesh)
    specs = dict(cell.policy.params)
    model = cell.abstract_args[0]
    whole = {k: (p.shape[0] * (mesh.size(1) if specs[k] else 1),)
             + tuple(p.shape[1:]) for k, p in model.named_parameters()}
    local = cells.local_shapes(cell.policy, specs, whole)
    placed = cells._shardings(cell.policy, specs)
    out["specs/local_ok"] = np.array(all(
        local[k] == tuple(p.shape) for k, p in model.named_parameters()))
    out["specs/placed_ok"] = np.array(all(
        spec_of(placed[k], mesh.mesh_dim_names, len(specs[k])) == specs[k]
        for k in specs))
    return out


def _f32(leaf) -> np.ndarray:
    """A host leaf as float32 numpy (a bf16 leaf is a CPU tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(leaf, dtype=np.float32)


def _bytes(a) -> bytes:
    """A host leaf's bytes (a bf16 leaf is a CPU tensor)."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def rank_main(rank: int, shape: tuple, workdir: str, inputs: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=math.prod(shape),
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT))
    try:
        out = rank_checks(shape, dict(np.load(inputs)))
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn_world(name: str, workdir: str, inputs: str) -> list[dict]:
    """Run world ``name`` once (one process a rank, gloo on the CPU, a
    ``file://`` rendezvous in ``workdir``); returns each rank's arrays."""
    import torch.multiprocessing as mp
    shape = WORLDS[name]
    world = math.prod(shape)
    mp.spawn(rank_main, args=(shape, workdir, inputs), nprocs=world,
             join=True)
    return [dict(np.load(os.path.join(workdir, f"rank{r}.npz")))
            for r in range(world)]


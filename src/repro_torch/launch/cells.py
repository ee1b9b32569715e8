"""Cell builder: (arch x shape) -> step + abstract inputs on the meta
device, for one device.

Twin of ``src/repro/launch/cells.py``. The dry run (``launch/dryrun.py``)
traces exactly what this module returns, on the meta device; with
``--measure`` it runs the same step on the card, on inputs that
``materialize`` draws at the same shapes, so the dry run proves the path
that runs.

What differs from the reference:

* No mesh: a cell is for one device. ``_lm_rules`` (the prefill and
  decode rule sets) is ported, since the model-parallel serving path
  runs under it (slice 16) and so does model-parallel training (slice
  17's training half: ``lm_loss`` and ``make_train_step`` under a
  policy); the other sharding specs (``_shardings``, ``opt_state_specs``,
  ``_zero1_opt_specs``, ``_recsys_param_specs``), the cells under a mesh
  and the ``zero1`` variant wait for the cells half of slice 17.
* A step takes the model first: the port's models are modules where the
  reference passes a params pytree. ``abstract_args`` are meta tensors
  and a meta model; a train cell's args are (model, ``TrainState`` of the
  model's parameters, batch), every other cell's (model, inputs...).
* ``cost_layers`` is gone: the reference builds unrolled 1- and 2-layer
  variants because XLA's ``cost_analysis`` counts a scanned layer once;
  the port's Python layer loop is traced whole.
* Serving steps run under ``torch.no_grad()`` (the models' parameters
  are trainable; the reference's jitted forward keeps no tape).
* LM prefill cells run ``attn_impl="flash"``, the port's serving path
  (train cells keep the reference's chunked attention: the kernel has no
  backward). Decode cells set ``max_seq = seq``, as the reference does
  (``cells.py:174-175``); prefill cells raise ``max_seq`` to ``seq``: the
  reference leaves a prompt longer than ``max_seq`` with an unpadded
  cache, where the port's ``prefill`` raises.
* A decode cell's cache starts ``DECODE_HEADROOM`` positions short of
  full: the port's ``decode_step`` raises on a full cache where the
  reference clamps (``models/transformer.py``).
* ``cut`` overrides shape dims (or ``n_layers``) so a cell fits one card;
  the cell's ``reduced`` lists each cut as (published, run).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.configs import base as cfg_base
from repro_torch.dist import policy as pol
from repro_torch.kernels import ref as kref
from repro_torch.models import gat as gat_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import init_state, make_train_step

N_RETRIEVE = 100          # top-k returned by retrieval serving
RETRIEVAL_CHUNKS = 4      # ranker bulk scoring runs 1M rows in 4 chunks
DECODE_HEADROOM = 8       # decode steps a decode cell's cache has room for
META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    kind: str                            # train|prefill|decode|serve|retrieval
    step: Callable                       # step(model, *inputs)
    abstract_args: tuple                 # on the meta device
    make_args: Callable                  # (device, generator) -> real args
    note: str = ""
    reduced: dict = dataclasses.field(default_factory=dict)


def materialize(cell: Cell, device, generator: torch.Generator) -> tuple:
    """Real arguments for ``cell.step`` on ``device``, drawn from
    ``generator`` (on the same device): weights at the family's init
    scales, ids uniform over each vocabulary, features, caches and
    candidate vectors N(0, 1)."""
    return cell.make_args(torch.device(device), generator)


def default_optimizer(family: str = "recsys", *,
                      policy=None) -> opt_lib.Optimizer:
    """The cells' optimizer of a family; under a mesh ``policy`` (carrying
    each parameter's layout rule) its statistics span whole leaves
    (``train/optimizer.py``)."""
    if family == "lm":
        # Factored second moment: 132B-param AdamW f32 m+v would be
        # 8.25 GB/chip at 256 chips (the reference's reason)
        return opt_lib.chain(opt_lib.clip_by_global_norm(1.0, policy=policy),
                             opt_lib.adafactor(3e-4, policy=policy))
    return opt_lib.chain(opt_lib.clip_by_global_norm(1.0, policy=policy),
                         opt_lib.adamw(3e-4, weight_decay=0.01))


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _ids(gen, high: int, shape, device) -> torch.Tensor:
    return torch.randint(0, high, tuple(shape), generator=gen,
                         device=device, dtype=torch.int32)


def _cut(shape: cfg_base.ShapeSpec, cfg, cut: dict | None):
    """(dims, cfg, reduced) with ``cut``'s dims (and ``n_layers``)
    applied."""
    dims, reduced = dict(shape.dims), {}
    for name, value in (cut or {}).items():
        if name == "n_layers":
            reduced[name] = (cfg.n_layers, value)
            cfg = dataclasses.replace(cfg, n_layers=value)
        elif name in dims:
            reduced[name] = (dims[name], value)
            dims[name] = value
        else:
            raise KeyError(f"{shape.name} has no dim {name!r} to cut")
    return dims, cfg, reduced


def _train_step(loss: Callable, optimizer, grad_accum: int = 1):
    """step(model, state, batch) of the trainer, ``loss(model, batch)``."""
    def step(model, state, batch):
        return make_train_step(lambda p, b: loss(model, b), optimizer,
                               grad_accum=grad_accum)(state, batch)
    return step


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_rules(arch: cfg_base.ArchSpec, kind: str, mesh,
              long_ctx: bool = False) -> dict[str, tuple]:
    """The LM rules of a cell on ``mesh`` (a ``DeviceMesh``;
    ``cells.py:121-144``). Train and prefill: ``lm_rules`` (pure data
    parallel for an arch that trains so, on 256 ranks), heads replicated
    where the arch's heads do not shard (``tp_heads=False``). Decode: the
    batch over the data axes and the KV cache's sequence over "model", or
    for a long context the batch replicated and the sequence over every
    axis."""
    names = tuple(mesh.mesh_dim_names or ())
    dp = tuple(a for a in pol.DP_AXIS_NAMES if a in names)
    tp = pol.TP_AXIS_NAME
    if kind in ("train", "prefill"):
        pure = arch.pure_dp_train and kind == "train" and mesh.size() == 256
        rules = pol.lm_rules(dp, tp, pure_dp=pure)
        if not arch.tp_heads and not pure:
            rules["act_bhsd"] = pol._spec(dp, None, None, None)
        return rules
    kv_seq = (dp + (tp,)) if long_ctx else (tp,)
    batch = () if long_ctx else dp
    rules = pol.lm_rules(dp, tp, pure_dp=False)
    rules.update({
        "act_btd": pol._spec(batch, None, None),
        "act_btf": pol._spec(batch, None, tp),
        "act_bhsd": pol._spec(batch, tp if arch.tp_heads else None, None,
                              None),
        "logits": pol._spec(batch, None, tp),
        "kv_cache": pol._spec(None, batch, None, kv_seq, None),
    })
    return rules


def build_lm_cell(arch: cfg_base.ArchSpec, shape: cfg_base.ShapeSpec,
                  cut: dict | None = None) -> Cell:
    dims, cfg, reduced = _cut(shape, arch.make_config(), cut)
    seq, batch = dims["seq_len"], dims["global_batch"]
    if shape.kind == "decode":
        cfg = dataclasses.replace(cfg, max_seq=seq)
    if shape.kind == "prefill":
        cfg = dataclasses.replace(cfg, attn_impl="flash",
                                  max_seq=max(cfg.max_seq, seq))
    model = tf_lib.LM(cfg, META)
    make_model = lambda dev, gen: tf_lib.init_params(cfg, gen, dev)  # noqa

    if shape.kind == "train":
        optimizer = default_optimizer("lm")
        accum = math.gcd(arch.train_grad_accum, batch)
        step = _train_step(lambda m, b: tf_lib.lm_loss(m, b, loss_chunk=512),
                           optimizer, accum)

        def make(dev, gen):
            m = make_model(dev, gen)
            seqs = _ids(gen, cfg.vocab, (batch, seq + 1), dev)
            return (m, init_state(dict(m.named_parameters()), optimizer),
                    {"tokens": seqs[:, :-1].contiguous(),
                     "labels": seqs[:, 1:].contiguous()})

        abstract = (model, init_state(dict(model.named_parameters()),
                                      optimizer),
                    {"tokens": _meta((batch, seq), torch.int32),
                     "labels": _meta((batch, seq), torch.int32)})
        return Cell(arch.arch_id, shape.name, shape.kind, step, abstract,
                    make, note=shape.note, reduced=reduced)

    if shape.kind == "prefill":
        def make(dev, gen):
            return make_model(dev, gen), _ids(gen, cfg.vocab, (batch, seq),
                                              dev)

        return Cell(arch.arch_id, shape.name, shape.kind, tf_lib.prefill,
                    (model, _meta((batch, seq), torch.int32)), make,
                    note=shape.note, reduced=reduced)

    # decode
    def make(dev, gen):
        kv = tf_lib.init_cache(cfg, batch, device=META)["k"].shape
        cache = {name: torch.randn(kv, generator=gen, device=dev,
                                   dtype=cfg.dtype) for name in ("k", "v")}
        cache["length"] = seq - DECODE_HEADROOM
        return make_model(dev, gen), cache, _ids(gen, cfg.vocab, (batch,),
                                                 dev)

    note = (f"{shape.note} The cache starts {DECODE_HEADROOM} positions "
            f"short of max_seq = {seq}: the port's decode_step raises on a "
            f"full cache, where the reference clamps.").strip()
    return Cell(arch.arch_id, shape.name, shape.kind, tf_lib.decode_step,
                (model, tf_lib.init_cache(cfg, batch, device=META),
                 _meta((batch,), torch.int32)),
                make, note=note, reduced=reduced)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def build_gnn_cell(arch: cfg_base.ArchSpec, shape: cfg_base.ShapeSpec,
                   cut: dict | None = None) -> Cell:
    dims, _, reduced = _cut(shape, arch.make_config(), cut)
    cfg = dataclasses.replace(arch.make_config(), d_in=dims["d_feat"],
                              n_classes=dims["n_classes"])
    n, e = dims["n_nodes"], dims["n_edges"]
    graph = {"x": _meta((n, dims["d_feat"]), torch.float32),
             "src": _meta((e,), torch.int32),
             "dst": _meta((e,), torch.int32),
             "edge_mask": _meta((e,), torch.bool)}
    if "n_graphs" in dims:
        graph["graph_id"] = _meta((n,), torch.int32)
        graph["graph_labels"] = _meta((dims["n_graphs"],), torch.int32)
    else:
        graph["labels"] = _meta((n,), torch.int32)
        graph["label_mask"] = _meta((n,), torch.bool)

    def draw_graph(dev, gen):
        """Every edge live. Batched small graphs: each graph's edges
        within its own nodes. Otherwise endpoints uniform over the nodes;
        a sampled subgraph labels its seeds, a full graph every node."""
        x = torch.randn(n, dims["d_feat"], generator=gen, device=dev)
        if "n_graphs" in dims:
            per, n_g = n // dims["n_graphs"], dims["n_graphs"]
            base = (torch.arange(e, device=dev) % n_g) * per
            src = (base + _ids(gen, per, (e,), dev)).to(torch.int32)
            dst = (base + _ids(gen, per, (e,), dev)).to(torch.int32)
            rest = {"graph_id": (torch.arange(n, device=dev) // per).to(
                        torch.int32),
                    "graph_labels": _ids(gen, dims["n_classes"], (n_g,), dev)}
        else:
            src, dst = _ids(gen, n, (e,), dev), _ids(gen, n, (e,), dev)
            rest = {"labels": _ids(gen, dims["n_classes"], (n,), dev),
                    "label_mask": (torch.arange(n, device=dev)
                                   < dims.get("batch_nodes", n))}
        return {"x": x, "src": src, "dst": dst,
                "edge_mask": torch.ones(e, dtype=torch.bool, device=dev),
                **rest}

    optimizer = default_optimizer()
    model = gat_lib.GATModel(cfg, META)
    step = _train_step(lambda m, b: gat_lib.loss_fn(m, b, cfg), optimizer)

    def make(dev, gen):
        m = gat_lib.init_params(cfg, gen, dev)
        return (m, init_state(dict(m.named_parameters()), optimizer),
                draw_graph(dev, gen))

    return Cell(arch.arch_id, shape.name, shape.kind, step,
                (model, init_state(dict(model.named_parameters()), optimizer),
                 graph), make, note=shape.note, reduced=reduced)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def _recsys_batch(arch: cfg_base.ArchSpec, cfg, batch: int) -> dict:
    """The abstract batch of a recsys arch (``cells.py:265-294``)."""
    if arch.arch_id in ("deepfm", "xdeepfm"):
        return {"sparse": _meta((batch, cfg.embedding.n_fields), torch.int32),
                "label": _meta((batch,), torch.float32)}
    if arch.arch_id == "din":
        return {"hist": _meta((batch, cfg.seq_len), torch.int32),
                "hist_mask": _meta((batch, cfg.seq_len), torch.bool),
                "target": _meta((batch,), torch.int32),
                "profile": _meta((batch, cfg.embedding.n_fields - 1),
                                 torch.int32),
                "label": _meta((batch,), torch.float32)}
    return {"user_feats": _meta((batch, cfg.user_embedding.n_fields),
                                torch.int32),
            "item_feats": _meta((batch, cfg.item_embedding.n_fields),
                                torch.int32),
            "log_q": _meta((batch,), torch.float32)}


def _fields(gen, vocab_sizes, rows: int, dev) -> torch.Tensor:
    return torch.stack([_ids(gen, v, (rows,), dev) for v in vocab_sizes], -1)


def draw_recsys_batch(cfg, keys, rows: int, dev, gen) -> dict:
    """A batch of ``rows`` with ``keys`` of a recsys batch: ids uniform
    over each field's vocabulary, DIN histories of a uniform length in
    1..T (a prefix mask), labels in {0, 1}, log_q 0 (uniform sampling)."""
    out = {}
    for key in keys:
        if key == "sparse":
            out[key] = _fields(gen, cfg.embedding.vocab_sizes, rows, dev)
        elif key == "hist":
            out[key] = _fields(gen, (cfg.embedding.vocab_sizes[0],)
                               * cfg.seq_len, rows, dev)
        elif key == "hist_mask":
            lengths = torch.randint(1, cfg.seq_len + 1, (rows, 1),
                                    generator=gen, device=dev)
            out[key] = torch.arange(cfg.seq_len, device=dev) < lengths
        elif key == "target":
            out[key] = _ids(gen, cfg.embedding.vocab_sizes[0], (rows,), dev)
        elif key == "profile":
            out[key] = _fields(gen, cfg.embedding.vocab_sizes[1:], rows, dev)
        elif key == "label":
            out[key] = _ids(gen, 2, (rows,), dev).to(torch.float32)
        elif key == "user_feats":
            out[key] = _fields(gen, cfg.user_embedding.vocab_sizes, rows, dev)
        elif key == "item_feats":
            out[key] = _fields(gen, cfg.item_embedding.vocab_sizes, rows, dev)
        elif key == "log_q":
            out[key] = torch.zeros(rows, device=dev)
    return out


def recsys_fns(arch: cfg_base.ArchSpec, cfg):
    """(init(generator, device) -> model, loss(model, batch), forward
    (model, batch) or None for two-tower) of a recsys arch."""
    if arch.arch_id in ("deepfm", "xdeepfm"):
        return (lambda g, d: rec_lib.init_ctr_params(g, cfg, device=d),
                lambda m, b: rec_lib.ctr_loss(m, b, cfg),
                lambda m, b: rec_lib.ctr_forward(m, b, cfg))
    if arch.arch_id == "din":
        return (lambda g, d: rec_lib.init_din_params(g, cfg, device=d),
                lambda m, b: rec_lib.din_loss(m, b, cfg),
                lambda m, b: rec_lib.din_forward(m, b, cfg))
    return (lambda g, d: rec_lib.init_twotower_params(g, cfg, device=d),
            lambda m, b: rec_lib.twotower_loss(m, b, cfg), None)


def build_recsys_cell(arch: cfg_base.ArchSpec, shape: cfg_base.ShapeSpec,
                      cut: dict | None = None) -> Cell:
    dims, cfg, reduced = _cut(shape, arch.make_config(), cut)
    init, loss, fwd = recsys_fns(arch, cfg)
    model = rec_lib.model_for(cfg, META)

    if shape.kind == "train":
        batch = dims["batch"]
        optimizer = default_optimizer()
        bshape = _recsys_batch(arch, cfg, batch)

        def make(dev, gen):
            m = init(gen, dev)
            return (m, init_state(dict(m.named_parameters()), optimizer),
                    draw_recsys_batch(cfg, bshape, batch, dev, gen))

        return Cell(arch.arch_id, shape.name, shape.kind,
                    _train_step(loss, optimizer),
                    (model, init_state(dict(model.named_parameters()),
                                       optimizer), bshape),
                    make, reduced=reduced)

    if shape.kind == "serve":
        batch = dims["batch"]
        bshape = _recsys_batch(arch, cfg, batch)
        bshape.pop("label", None)
        if arch.arch_id == "two-tower-retrieval":
            bshape.pop("log_q", None)

            @torch.no_grad()
            def step(m, b):
                u = rec_lib.user_tower(m, b["user_feats"], cfg)
                v = rec_lib.item_tower(m, b["item_feats"], cfg)
                return torch.sum(u * v, dim=-1)
        else:
            step = torch.no_grad()(fwd)

        def make(dev, gen):
            return init(gen, dev), draw_recsys_batch(cfg, bshape, batch,
                                                     dev, gen)

        return Cell(arch.arch_id, shape.name, shape.kind, step,
                    (model, bshape), make, reduced=reduced)

    # retrieval_cand
    return _build_retrieval_cell(arch, shape, dims, cfg, reduced, init)


def _build_retrieval_cell(arch, shape, dims, cfg, reduced, init) -> Cell:
    n_cand = dims["n_candidates"]
    model = rec_lib.model_for(cfg, META)

    if arch.arch_id == "two-tower-retrieval":
        # candidates embedded offline; one query scored against all of
        # them, exactly (the SAH sketch variant: launch/serve.py)
        @torch.no_grad()
        def step(m, user_feats, cand_vecs):
            u = rec_lib.user_tower(m, user_feats, cfg)[0]
            vals, pos = kref.topk_stable(cand_vecs @ u, N_RETRIEVE)
            return vals, pos.to(torch.int32)

        def make(dev, gen):
            return (init(gen, dev),
                    _fields(gen, cfg.user_embedding.vocab_sizes, 1, dev),
                    torch.randn(n_cand, cfg.out_dim, generator=gen,
                                device=dev))

        abstract = (model,
                    _meta((1, cfg.user_embedding.n_fields), torch.int32),
                    _meta((n_cand, cfg.out_dim), torch.float32))
        return Cell(arch.arch_id, shape.name, shape.kind, step, abstract,
                    make, reduced=reduced,
                    note="exact MIPS baseline; SAH sketch variant is the "
                         "paper-technique cell (dryrun --sah)")

    # Rankers: bulk-score n_cand candidate rows for one user context in
    # RETRIEVAL_CHUNKS sequential chunks, as the reference's lax.map
    # does to keep peak residency at serve_bulk levels
    bulk = cfg_base.ShapeSpec("serve_bulk", "serve",
                              {"batch": n_cand // RETRIEVAL_CHUNKS})
    inner = build_recsys_cell(arch, bulk)
    rows = n_cand // RETRIEVAL_CHUNKS

    def chunked_step(m, b):
        return torch.cat([inner.step(m, {k: v[i * rows:(i + 1) * rows]
                                         for k, v in b.items()})
                          for i in range(RETRIEVAL_CHUNKS)])

    bshape = _recsys_batch(arch, cfg, n_cand)
    bshape.pop("label", None)

    def make(dev, gen):
        return init(gen, dev), draw_recsys_batch(cfg, bshape, n_cand, dev,
                                                 gen)

    return Cell(arch.arch_id, shape.name, shape.kind, chunked_step,
                (model, bshape), make, reduced=reduced,
                note=f"retrieval_cand = bulk scoring of {n_cand:,} candidate "
                     f"rows against one user context, in "
                     f"{RETRIEVAL_CHUNKS} chunks for HBM residency")


# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, cut: dict | None = None
               ) -> Cell:
    arch = cfg_base.get(arch_id)
    shape = arch.shape(shape_name)
    if arch.family == "lm":
        return build_lm_cell(arch, shape, cut)
    if arch.family == "gnn":
        return build_gnn_cell(arch, shape, cut)
    return build_recsys_cell(arch, shape, cut)

"""Cell builder: (arch x shape x mesh) -> step + abstract inputs on the
meta device.

Twin of ``src/repro/launch/cells.py``. The dry run (``launch/dryrun.py``)
traces exactly what this module returns, on the meta device; with
``--measure`` it runs the same step on the card, on inputs that
``materialize`` draws at the same shapes, so the dry run proves the path
that runs.

Under a mesh (``build_cell(..., mesh=)``, a ``DeviceMesh``; explicit
SPMD) a cell is what **one rank** runs: its ``abstract_args`` are the
rank's shards on the meta device, its step runs the family's mesh path
under the cell's ``policy`` (the reference's rules: ``_lm_rules``, the
ZeRO-1 variant's pure data parallelism, GAT's edge shards, the recsys
``act_btd`` with row-sharded tables), and ``materialize`` draws the same
global inputs as the one-device cell, from the same generator, and cuts
the rank's shard. A mesh cell and the one-device cell therefore compute
the same global step (PORT.md, "The cells under a mesh"). The
reference's sharding specs are data here: a rule (a tuple of mesh axes
per dim, ``dist/policy.py``) per leaf, and from it the rank's local shape
(``_shardings``, ``local_shapes``, ``opt_state_specs``,
``_zero1_opt_specs``, ``_recsys_param_specs``).

What differs from the reference:

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
* The ``zero1`` variant holds each optimizer-state leaf as
  ``_zero1_opt_specs`` shards it; the reference defines those specs but
  its cell places the state by ``opt_state_specs`` of its replicated
  parameters, so its ZeRO-1 state is replicated (PORT.md).
* Explicit SPMD needs every sharded dim to divide: a GNN cell's edges
  are padded with dead edges to a multiple of the ranks (GSPMD pads them
  itself), and the ``dst_partitioned`` variant draws its edges by owner
  blocks (``DST_BLOCKS``; the reference takes the loader's word for it).
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
from repro_torch.train.trainer import TrainState, init_state, make_train_step

N_RETRIEVE = 100          # top-k returned by retrieval serving
RETRIEVAL_CHUNKS = 4      # ranker bulk scoring runs 1M rows in 4 chunks
DECODE_HEADROOM = 8       # decode steps a decode cell's cache has room for
CAND_PAD = 1 << 20        # retrieval candidates under a mesh (2^20)
DST_BLOCKS = 512          # dst_partitioned: node (and edge) blocks
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
    policy: pol.ShardingPolicy = pol.NO_SHARDING   # the rank's, on a mesh


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


def _train_step(loss: Callable, optimizer, grad_accum: int = 1,
                policy=None):
    """step(model, state, batch) of the trainer, ``loss(model, batch)``
    (under a mesh ``policy``, the rank's step)."""
    def step(model, state, batch):
        return make_train_step(lambda p, b: loss(model, b), optimizer,
                               grad_accum=grad_accum,
                               policy=policy)(state, batch)
    return step


# ---------------------------------------------------------------------------
# The sharding specs as data
# ---------------------------------------------------------------------------


def _shardings(policy: pol.ShardingPolicy, specs: dict) -> dict | None:
    """The reference's ``NamedSharding`` tree (``cells.py:42``) of
    ``specs`` ({key: rule}): each rule as the ``DeviceMesh`` placements
    ``ShardingPolicy.sharding`` gives (one ``Shard(dim)`` or
    ``Replicate()`` a mesh dimension). None without a mesh."""
    if policy.mesh is None:
        return None
    return {k: pol.ShardingPolicy(mesh=policy.mesh, rules={"r": r})
            .sharding("r") for k, r in specs.items()}


def local_shapes(policy: pol.ShardingPolicy, specs: dict,
                 shapes: dict) -> dict:
    """{key: the rank's shape} of whole ``shapes`` ({key: shape}) in the
    layouts ``specs`` ({key: rule}); a dim its axes do not divide
    raises."""
    return {k: policy.local_shape(tuple(shape), specs[k], k)
            for k, shape in shapes.items()}


def opt_state_specs(state, policy: pol.ShardingPolicy) -> dict:
    """The optimizer-state specs (``cells.py:68``) of a ``TrainState``, as
    {checkpoint path: rule} of the reference's nest: each moment takes
    its parameter's rule (the rules ``policy`` carries), Adafactor's ``r``
    the rule less its last dim, ``c`` less its second to last, a stacked
    layer leaf a None first, the step counters replicated. One mapping
    with the checkpoints' (``models/convert.py::state_rules``)."""
    from repro_torch.models import convert
    head = ".opt_state/"
    return {k[len(head):]: r
            for k, r in convert.state_rules(state, policy).items()
            if k.startswith(head)}


def _zero1_opt_specs(tree, policy: pol.ShardingPolicy) -> dict:
    """ZeRO-1's specs (``cells.py:146``) of the whole tensors of ``tree``
    (a ``TrainState`` or any nest; an LM's layers as the reference's
    stacks, ``convert.reference_layout``), as {checkpoint path: rule}:
    each sharded over every mesh axis on its first dim the device count
    divides, else replicated (``optimizer.zero1_rule``)."""
    from repro_torch.models import convert
    from repro_torch.train.checkpoint import flatten_with_paths
    names = (set(tree.params) if isinstance(tree, TrainState) else set())
    ref = convert.reference_layout(tree, names)
    return {k: opt_lib.zero1_rule(tuple(t.shape), policy)
            for k, t in flatten_with_paths(ref)
            if isinstance(t, torch.Tensor)}


def _recsys_param_specs(model, tables) -> dict[str, tuple]:
    """Each recsys parameter's rule (``cells.py:367``): the embedding
    tables ``tables`` row-sharded over "model", the rest replicated."""
    return {name: ((pol.TP_AXIS_NAME, None) if name.split(".")[0] in tables
                   else ()) for name, _ in model.named_parameters()}


def _rows(policy, x: torch.Tensor, axes) -> torch.Tensor:
    """The rank's rows of the whole ``x`` tiled over ``axes`` (a copy)."""
    return policy.relayout(x, (), (axes,) + (None,) * (x.dim() - 1)
                           ).clone()


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
                  cut: dict | None = None, mesh=None,
                  variant: str = "") -> Cell:
    """An LM cell; under ``mesh`` one rank's. ``variant="zero1"`` (train
    cells under a mesh): pure data parallelism over every mesh axis, the
    parameters replicated and each optimizer-state leaf sharded by
    ``_zero1_opt_specs`` (``optimizer.zero1``), the loss in one chunk
    (``loss_chunk = seq * batch``; a rank's batch is small)."""
    dims, cfg, reduced = _cut(shape, arch.make_config(), cut)
    seq, batch = dims["seq_len"], dims["global_batch"]
    if shape.kind == "decode":
        cfg = dataclasses.replace(cfg, max_seq=seq)
    if shape.kind == "prefill":
        cfg = dataclasses.replace(cfg, attn_impl="flash",
                                  max_seq=max(cfg.max_seq, seq))
    if variant not in ("", "zero1") or (variant and (
            mesh is None or shape.kind != "train")):
        raise ValueError(f"LM variant {variant!r}: the only one is 'zero1', "
                         f"of a train cell under a mesh")
    if mesh is not None:
        return _lm_mesh_cell(arch, shape, cfg, dims, reduced, mesh, variant)
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
        cache = _draw_cache(cfg, batch, dev, gen)
        cache["length"] = seq - DECODE_HEADROOM
        return make_model(dev, gen), cache, _ids(gen, cfg.vocab, (batch,),
                                                 dev)

    return Cell(arch.arch_id, shape.name, shape.kind, tf_lib.decode_step,
                (model, tf_lib.init_cache(cfg, batch, device=META),
                 _meta((batch,), torch.int32)),
                make, note=_decode_note(shape, seq), reduced=reduced)


def _draw_cache(cfg, batch: int, dev, gen) -> dict:
    kv = tf_lib.init_cache(cfg, batch, device=META)["k"].shape
    return {name: torch.randn(kv, generator=gen, device=dev,
                              dtype=cfg.dtype) for name in ("k", "v")}


def _decode_note(shape, seq: int) -> str:
    return (f"{shape.note} The cache starts {DECODE_HEADROOM} positions "
            f"short of max_seq = {seq}: the port's decode_step raises on a "
            f"full cache, where the reference clamps.").strip()


def _lm_mesh_cell(arch, shape, cfg, dims, reduced, mesh, variant) -> Cell:
    """One rank's LM cell (``cells.py:161-254``): the model's shards under
    the cell's rules, the rank's rows of the batch (whole sequences), a
    decode cache in ``kv_cache``'s layout; ``materialize`` draws what the
    one-device cell draws and keeps the rank's shard."""
    seq, batch = dims["seq_len"], dims["global_batch"]
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in pol.DP_AXIS_NAMES if a in names)
    long_ctx = shape.name.startswith("long")
    if variant == "zero1":
        rules = pol.lm_rules(dp, pol.TP_AXIS_NAME, pure_dp=True)
    else:
        rules = _lm_rules(arch, shape.kind, mesh, long_ctx)
    policy = pol.ShardingPolicy(mesh=mesh, rules=rules)
    heads = policy.axes_size(policy.axes("act_bhsd")[1])
    if shape.kind != "decode" and (cfg.n_heads % heads
                                   or cfg.n_kv_heads % heads):
        # KV heads that do not divide over "model" (8 on 16 ranks): GSPMD
        # pads the head dim; explicit SPMD takes the replicated-heads
        # layout of tp_heads=False (each rank gathers q/k/v to every
        # head), the weights still sharded
        rules = {**rules, "act_bhsd": (rules["act_bhsd"][0], None, None,
                                       None)}
        policy = pol.ShardingPolicy(mesh=mesh, rules=rules)
    policy = policy.with_params(tf_lib.param_rules(cfg, policy))
    rows = rules["act_btd"][0]
    b_local = policy.local_shape((batch,), (rows,), "the batch")[0]
    model = tf_lib.shard_lm(tf_lib.LM(cfg, META), policy)

    def make_model(dev, gen):
        return tf_lib.init_params(cfg, gen, dev, policy=policy)

    if shape.kind == "train":
        if variant == "zero1":
            # the parameters are whole under pure data parallelism
            zpol = policy.with_params(opt_lib.zero1_rules(
                dict(model.named_parameters()), policy))
            optimizer = opt_lib.zero1(default_optimizer("lm", policy=zpol),
                                      zpol)
            loss_chunk = seq * batch
        else:
            optimizer = default_optimizer("lm", policy=policy)
            loss_chunk = 512
        accum = math.gcd(arch.train_grad_accum, b_local)
        step = _train_step(
            lambda m, b: tf_lib.lm_loss(m, b, policy, loss_chunk=loss_chunk),
            optimizer, accum, policy)

        def make(dev, gen):
            m = make_model(dev, gen)
            seqs = _ids(gen, cfg.vocab, (batch, seq + 1), dev)
            return (m, init_state(dict(m.named_parameters()), optimizer),
                    {"tokens": _rows(policy, seqs[:, :-1], rows),
                     "labels": _rows(policy, seqs[:, 1:], rows)})

        abstract = (model, init_state(dict(model.named_parameters()),
                                      optimizer),
                    {"tokens": _meta((b_local, seq), torch.int32),
                     "labels": _meta((b_local, seq), torch.int32)})
        return Cell(arch.arch_id, shape.name, shape.kind, step, abstract,
                    make, note=shape.note, reduced=reduced, policy=policy)

    if shape.kind == "prefill":
        def make(dev, gen):
            m = make_model(dev, gen)
            return m, _rows(policy, _ids(gen, cfg.vocab, (batch, seq), dev),
                            rows)

        return Cell(arch.arch_id, shape.name, shape.kind,
                    lambda m, t: tf_lib.prefill(m, t, policy),
                    (model, _meta((b_local, seq), torch.int32)), make,
                    note=shape.note, reduced=reduced, policy=policy)

    # decode: the cache in kv_cache's layout, the batch over act_btd's rows
    def local_cache(cache):
        out = {name: policy.relayout(cache[name], (), rules["kv_cache"])
               .clone() for name in ("k", "v")}
        out["length"] = seq - DECODE_HEADROOM
        return out

    def make(dev, gen):
        cache = _draw_cache(cfg, batch, dev, gen)
        m = make_model(dev, gen)
        return (m, local_cache(cache),
                _rows(policy, _ids(gen, cfg.vocab, (batch,), dev), rows))

    return Cell(arch.arch_id, shape.name, shape.kind,
                lambda m, c, t: tf_lib.decode_step(m, c, t, policy),
                (model, local_cache(tf_lib.init_cache(cfg, batch,
                                                      device=META)),
                 _meta((b_local,), torch.int32)),
                make, note=_decode_note(shape, seq), reduced=reduced,
                policy=policy)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def build_gnn_cell(arch: cfg_base.ArchSpec, shape: cfg_base.ShapeSpec,
                   cut: dict | None = None, mesh=None,
                   variant: str = "") -> Cell:
    """A GAT train cell; under ``mesh`` one rank's (``cells.py:257-310``):
    the edges tiled over every mesh axis, the rest of the graph and the
    parameters whole. ``variant="dst_partitioned"`` aggregates by
    destination owner (``models/gat.py``): the node count padded to a
    multiple of ``DST_BLOCKS``, as the reference pads it, and the edges
    drawn in owner blocks (``draw_graph``), so that every rank's edge
    shard points into the nodes it owns on any mesh whose size divides
    ``DST_BLOCKS``."""
    dims, _, reduced = _cut(shape, arch.make_config(), cut)
    cfg = dataclasses.replace(arch.make_config(), d_in=dims["d_feat"],
                              n_classes=dims["n_classes"])
    dst_part, n_real = variant == "dst_partitioned", dims["n_nodes"]
    if variant not in ("", "dst_partitioned"):
        raise ValueError(f"GNN variant {variant!r}: the only one is "
                         f"'dst_partitioned'")
    if dst_part:
        if "n_graphs" in dims:
            raise ValueError(f"{shape.name}: dst_partitioned partitions a "
                             f"node-level graph's edges by owner; this "
                             f"shape batches small graphs")
        cfg = dataclasses.replace(cfg, agg_mode="dst_partitioned")
        dims = dict(dims)
        dims["n_nodes"] = -(-dims["n_nodes"] // DST_BLOCKS) * DST_BLOCKS
    n, e = dims["n_nodes"], dims["n_edges"]
    e_all = -(-e // DST_BLOCKS) * DST_BLOCKS if dst_part else e
    policy, e_local, note = pol.NO_SHARDING, e_all, shape.note
    if mesh is not None:
        policy = pol.ShardingPolicy(mesh=mesh, rules={})
        n_dev = policy.device_count
        if dst_part and DST_BLOCKS % n_dev:
            raise ValueError(f"dst_partitioned: {n_dev} ranks do not divide "
                             f"the {DST_BLOCKS} owner blocks")
        e_local = -(-e_all // n_dev)
        note = (f"{shape.note} Edges tiled over {n_dev} ranks, "
                f"{e_local * n_dev - e} dead edges padding them.").strip()
    graph = {"x": _meta((n, dims["d_feat"]), torch.float32),
             "src": _meta((e_local,), torch.int32),
             "dst": _meta((e_local,), torch.int32),
             "edge_mask": _meta((e_local,), torch.bool)}
    if "n_graphs" in dims:
        graph["graph_id"] = _meta((n,), torch.int32)
        graph["graph_labels"] = _meta((dims["n_graphs"],), torch.int32)
    else:
        graph["labels"] = _meta((n,), torch.int32)
        graph["label_mask"] = _meta((n,), torch.bool)

    def draw_graph(dev, gen):
        """Every edge live. Batched small graphs: each graph's edges
        within its own nodes. Otherwise endpoints uniform over the nodes;
        a sampled subgraph labels its seeds, a full graph every (real)
        node. dst_partitioned: the edges in ``DST_BLOCKS`` equal blocks,
        block b's destinations uniform over the b-th block of nodes (the
        edges past ``n_edges`` dead), sources uniform."""
        x = torch.randn(n, dims["d_feat"], generator=gen, device=dev)
        if "n_graphs" in dims:
            per, n_g = n // dims["n_graphs"], dims["n_graphs"]
            base = (torch.arange(e, device=dev) % n_g) * per
            src = (base + _ids(gen, per, (e,), dev)).to(torch.int32)
            dst = (base + _ids(gen, per, (e,), dev)).to(torch.int32)
            rest = {"graph_id": (torch.arange(n, device=dev) // per).to(
                        torch.int32),
                    "graph_labels": _ids(gen, dims["n_classes"], (n_g,), dev)}
        elif dst_part:
            per_e, per_n = e_all // DST_BLOCKS, n // DST_BLOCKS
            src = _ids(gen, n_real, (e_all,), dev)
            dst = ((torch.arange(e_all, device=dev) // per_e) * per_n
                   + _ids(gen, per_n, (e_all,), dev)).to(torch.int32)
            rest = {"labels": _ids(gen, dims["n_classes"], (n,), dev),
                    "label_mask": (torch.arange(n, device=dev)
                                   < min(dims.get("batch_nodes", n_real),
                                         n_real))}
        else:
            src, dst = _ids(gen, n, (e,), dev), _ids(gen, n, (e,), dev)
            rest = {"labels": _ids(gen, dims["n_classes"], (n,), dev),
                    "label_mask": (torch.arange(n, device=dev)
                                   < dims.get("batch_nodes", n))}
        return {"x": x, "src": src, "dst": dst,
                "edge_mask": torch.arange(src.shape[0], device=dev) < e,
                **rest}

    def cut_edges(g):
        """The rank's shard of the edges, padded with dead edges (node 0,
        masked) to a multiple of the ranks."""
        if mesh is None:
            return g
        g = dict(g)
        pad = e_local * policy.device_count - g["src"].shape[0]
        axes = tuple(mesh.mesh_dim_names)
        for k, fill in (("src", 0), ("dst", 0), ("edge_mask", False)):
            t = torch.cat([g[k], torch.full((pad,), fill, dtype=g[k].dtype,
                                            device=g[k].device)])
            g[k] = _rows(policy, t, axes)
        return g

    model = gat_lib.GATModel(cfg, META)
    if mesh is not None:
        policy = policy.with_params({k: () for k, _ in
                                     model.named_parameters()})
    optimizer = default_optimizer(policy=policy if mesh is not None
                                  else None)
    step = _train_step(lambda m, b: gat_lib.loss_fn(m, b, cfg, policy),
                       optimizer, policy=policy if mesh is not None
                       else None)

    def make(dev, gen):
        m = gat_lib.init_params(cfg, gen, dev)
        return (m, init_state(dict(m.named_parameters()), optimizer),
                cut_edges(draw_graph(dev, gen)))

    return Cell(arch.arch_id, shape.name, shape.kind, step,
                (model, init_state(dict(model.named_parameters()), optimizer),
                 graph), make, note=note, reduced=reduced, policy=policy)


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


def recsys_fns(arch: cfg_base.ArchSpec, cfg, policy=None,
               table_pad: int = 1):
    """(init(generator, device) -> model, loss(model, batch), forward
    (model, batch) or None for two-tower) of a recsys arch; under a mesh
    ``policy`` the losses and forwards take it and ``init`` pads each
    table's rows to ``table_pad``."""
    if arch.arch_id in ("deepfm", "xdeepfm"):
        return (lambda g, d: rec_lib.init_ctr_params(
                    g, cfg, device=d, table_pad=table_pad),
                lambda m, b: rec_lib.ctr_loss(m, b, cfg, policy),
                lambda m, b: rec_lib.ctr_forward(m, b, cfg, policy))
    if arch.arch_id == "din":
        return (lambda g, d: rec_lib.init_din_params(
                    g, cfg, device=d, table_pad=table_pad),
                lambda m, b: rec_lib.din_loss(m, b, cfg, policy),
                lambda m, b: rec_lib.din_forward(m, b, cfg, policy))
    return (lambda g, d: rec_lib.init_twotower_params(
                g, cfg, device=d, table_pad=table_pad),
            lambda m, b: rec_lib.twotower_loss(m, b, cfg, policy), None)


def recsys_mesh(arch: cfg_base.ArchSpec, cfg, mesh):
    """(policy, table_pad, the rank's model on the meta device) of a
    recsys cell under ``mesh`` (``cells.py:367-381``): ``act_btd`` over
    the data axes, each table padded to the "model" axis and row-sharded
    over it, the rest replicated; the policy carries each parameter's
    rule (``_recsys_param_specs``)."""
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in pol.DP_AXIS_NAMES if a in names)
    policy = pol.ShardingPolicy(mesh=mesh,
                                rules={"act_btd": pol._spec(dp, None, None)})
    pad = policy.model_axis_size
    model = rec_lib.model_for(cfg, META)
    tables = rec_lib.TABLES[type(model).__name__]
    for name in tables:
        t = getattr(model, name)
        rows = -(-t.shape[0] // pad) * pad
        setattr(model, name, torch.nn.Parameter(_meta((rows, t.shape[1]),
                                                      t.dtype)))
    rec_lib.shard_tables(model, policy)
    policy = policy.with_params(_recsys_param_specs(model, tables))
    return policy, pad, model


def build_recsys_cell(arch: cfg_base.ArchSpec, shape: cfg_base.ShapeSpec,
                      cut: dict | None = None, mesh=None) -> Cell:
    """A recsys cell; under ``mesh`` one rank's (``cells.py:381-436``):
    the rank's rows of the batch over the data axes, the tables
    row-sharded over "model"."""
    dims, cfg, reduced = _cut(shape, arch.make_config(), cut)
    policy, pad = pol.NO_SHARDING, 1
    model = rec_lib.model_for(cfg, META)
    if mesh is not None:
        policy, pad, model = recsys_mesh(arch, cfg, mesh)
    meshed = mesh is not None
    init, loss, fwd = recsys_fns(arch, cfg, policy if meshed else None, pad)
    rows = policy.dp_axes()

    def init_model(gen, dev):
        return rec_lib.shard_tables(init(gen, dev), policy)

    def local(b: dict) -> dict:
        return {k: _rows(policy, v, rows) for k, v in b.items()} \
            if meshed else b

    if shape.kind == "train":
        batch = dims["batch"]
        b_local = policy.local_shape((batch,), (rows,), "the batch")[0]
        optimizer = default_optimizer(policy=policy if meshed else None)
        bshape = _recsys_batch(arch, cfg, b_local)

        def make(dev, gen):
            m = init_model(gen, dev)
            return (m, init_state(dict(m.named_parameters()), optimizer),
                    local(draw_recsys_batch(cfg, bshape, batch, dev, gen)))

        return Cell(arch.arch_id, shape.name, shape.kind,
                    _train_step(loss, optimizer,
                                policy=policy if meshed else None),
                    (model, init_state(dict(model.named_parameters()),
                                       optimizer), bshape),
                    make, reduced=reduced, policy=policy)

    if shape.kind == "serve":
        batch = dims["batch"]
        b_local = policy.local_shape((batch,), (rows,), "the batch")[0]
        bshape = _recsys_batch(arch, cfg, b_local)
        bshape.pop("label", None)
        if arch.arch_id == "two-tower-retrieval":
            bshape.pop("log_q", None)
            pass_pol = policy if meshed else None

            @torch.no_grad()
            def step(m, b):
                u = rec_lib.user_tower(m, b["user_feats"], cfg, pass_pol)
                v = rec_lib.item_tower(m, b["item_feats"], cfg, pass_pol)
                return torch.sum(u * v, dim=-1)
        else:
            step = torch.no_grad()(fwd)

        def make(dev, gen):
            return init_model(gen, dev), local(draw_recsys_batch(
                cfg, bshape, batch, dev, gen))

        return Cell(arch.arch_id, shape.name, shape.kind, step,
                    (model, bshape), make, reduced=reduced, policy=policy)

    # retrieval_cand
    return _build_retrieval_cell(arch, shape, dims, cfg, reduced, init_model,
                                 mesh, policy, model)


def _build_retrieval_cell(arch, shape, dims, cfg, reduced, init, mesh,
                          policy, model) -> Cell:
    n_cand = dims["n_candidates"]
    meshed = mesh is not None

    if arch.arch_id == "two-tower-retrieval":
        # candidates embedded offline; one query scored against all of
        # them, exactly (the SAH sketch variant: launch/serve.py). Under a
        # mesh CAND_PAD rows tiled over every axis, the rows past n_cand
        # dead; each rank's top-k, gathered and merged in mesh order
        n_rows = max(CAND_PAD, n_cand) if meshed else n_cand
        axes = tuple(mesh.mesh_dim_names) if meshed else ()
        n_local = policy.local_shape((n_rows,), (axes,), "candidates")[0]

        @torch.no_grad()
        def step(m, user_feats, cand_vecs):
            u = rec_lib.user_tower(m, user_feats, cfg,
                                   policy if meshed else None)[0]
            scores = cand_vecs @ u
            if not meshed:
                vals, pos = kref.topk_stable(scores, N_RETRIEVE)
                return vals, pos.to(torch.int32)
            first = policy.axis_index(axes) * n_local
            ids = torch.arange(first, first + n_local, device=u.device)
            scores = torch.where(ids < n_cand, scores, float("-inf"))
            vals, pos = kref.topk_stable(scores, N_RETRIEVE)
            vals = policy.relayout(vals, (axes,), ())
            ids = policy.relayout(ids[pos], (axes,), ())
            best, at = kref.topk_stable(vals, N_RETRIEVE)
            return best, ids[at].to(torch.int32)

        def make(dev, gen):
            m = init(gen, dev)
            feats = _fields(gen, cfg.user_embedding.vocab_sizes, 1, dev)
            cand = torch.randn(n_rows, cfg.out_dim, generator=gen,
                               device=dev)
            return m, feats, (_rows(policy, cand, axes) if meshed else cand)

        abstract = (model,
                    _meta((1, cfg.user_embedding.n_fields), torch.int32),
                    _meta((n_local, cfg.out_dim), torch.float32))
        note = ("exact MIPS baseline; SAH sketch variant is the "
                "paper-technique cell (dryrun --sah)")
        if meshed:
            note += (f"; {n_rows:,} candidate rows tiled over {axes}, the "
                     f"{n_rows - n_cand:,} past {n_cand:,} dead")
        return Cell(arch.arch_id, shape.name, shape.kind, step, abstract,
                    make, reduced=reduced, note=note, policy=policy)

    # Rankers: bulk-score n_cand candidate rows for one user context in
    # RETRIEVAL_CHUNKS sequential chunks, as the reference's lax.map
    # does to keep peak residency at serve_bulk levels; under a mesh the
    # rank's rows of them
    rows = policy.dp_axes()
    n_local = policy.local_shape((n_cand,), (rows,), "candidates")[0]
    serve = torch.no_grad()(recsys_fns(arch, cfg, policy if meshed
                                       else None)[2])

    def chunked_step(m, b):
        parts = zip(*(torch.tensor_split(v, RETRIEVAL_CHUNKS)
                      for v in b.values()))
        return torch.cat([serve(m, dict(zip(b, part))) for part in parts])

    bshape = _recsys_batch(arch, cfg, n_local)
    bshape.pop("label", None)

    def make(dev, gen):
        m = init(gen, dev)
        batch = draw_recsys_batch(cfg, bshape, n_cand, dev, gen)
        if meshed:
            batch = {k: _rows(policy, v, rows) for k, v in batch.items()}
        return m, batch

    return Cell(arch.arch_id, shape.name, shape.kind, chunked_step,
                (model, bshape), make, reduced=reduced, policy=policy,
                note=f"retrieval_cand = bulk scoring of {n_cand:,} candidate "
                     f"rows against one user context, in "
                     f"{RETRIEVAL_CHUNKS} chunks for HBM residency")


# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, cut: dict | None = None,
               mesh=None, variant: str = "") -> Cell:
    """The cell of (arch, shape): one device's, or under ``mesh`` (a
    ``DeviceMesh``) one rank's. ``variant``: ``"zero1"`` (an LM train
    cell under a mesh) or ``"dst_partitioned"`` (a GNN cell)."""
    arch = cfg_base.get(arch_id)
    shape = arch.shape(shape_name)
    if arch.family == "lm":
        return build_lm_cell(arch, shape, cut, mesh, variant)
    if arch.family == "gnn":
        return build_gnn_cell(arch, shape, cut, mesh, variant)
    if variant:
        raise ValueError(f"{arch_id} has no variant {variant!r}")
    return build_recsys_cell(arch, shape, cut, mesh)

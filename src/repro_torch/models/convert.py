"""The reference's LM and recsys parameters into the port's modules.

``params_from_jax`` takes the pytree of ``repro.models.transformer.
init_params`` (or a checkpoint of it) as numpy arrays, layer leaves with
their leading (L,) axis, and copies each leaf into exactly one parameter
of an ``LM``: ``tree["layers"][name][i]`` into ``model.blocks[i].<name>``,
and ``embed``, ``head`` and ``final_norm`` as they are. Both sides keep
the (in, out) layout, so the copy is bitwise.

``recsys_params_from_jax`` does the same for the pytrees of
``repro.models.recsys``'s ``init_ctr_params``, ``init_din_params`` and
``init_twotower_params``: leaf ``tree[a][i][b]`` lands on the parameter
named ``a.i.b`` of the config's ``models/recsys.py`` model.

Under a mesh ``policy`` both give the rank's shard: the LM cut by
``transformer.shard_lm`` (``param_specs``), a recsys model's tables (made
with the reference's ``table_pad``) by ``recsys.shard_tables``.

``gat_params_from_jax`` does it for ``repro.models.gat.init_params``
(``layers.i.w`` and so on).

``train_state_to_numpy`` and ``train_state_from_jax`` carry a whole
``TrainState`` (parameters, optimizer state, step) between the port's
layout and the reference's pytree, so both packages take the same steps
from the same state and each resumes the other's checkpoint. A
parameter-keyed dict of the port (the parameters, and each moment of the
optimizer state) maps onto the reference's nest: ``a.0.b`` onto
``a/0/b`` (a list at ``a``), and the LM's per-layer ``blocks.i.a.b`` onto
row i of the stacked ``layers/a/b`` (``blocks.i.moe.router`` onto
``layers/moe/router``). A state tensor that every layer's entry holds as
the same object is the stack's one leaf, not a row of it: Adafactor's
``c`` of a 1-D stack (the norm scales), shared by the layers as the
reference shares it (``train/optimizer.py``).

Under a mesh (``policy=``, carrying each parameter's layout rule:
``policy.with_params(transformer.param_rules(cfg, policy))``) a rank's
``TrainState`` holds its shards. ``train_state_to_numpy`` gathers each
leaf whole, in mesh order, onto the mesh's first rank, the one that
writes checkpoints, so the tree is the reference's whatever the mesh;
the other ranks only send their shards. ``state_rules`` gives every
leaf's rule by its checkpoint path (an optimizer moment takes its
parameter's, Adafactor's ``r`` and ``c`` the rule less the dim they
average), and ``shard_cut`` cuts a rank's shard from a whole leaf by it:
the one cut of the elastic restore, which ``train/checkpoint.py::
restore(..., cut=)`` applies leaf by leaf as it reads.
``train_state_from_jax`` then copies the rank's tree as it is.

It reads numpy only: a JAX array passes through ``np.asarray``, and a
bf16 array arrives as numpy dtype ``bfloat16`` (``ml_dtypes``), which
``torch.from_numpy`` rejects; it travels as its ``uint16`` bits instead.
Going back, a bf16 leaf leaves as a CPU bfloat16 tensor (where there is no
``ml_dtypes``, numpy has no bfloat16), every other leaf as numpy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import gat, recsys
from repro_torch.models.transformer import LM, LMConfig, shard_lm
from repro_torch.train.optimizer import LAYER_LEAF as _BLOCK


def _tensor_from_numpy(a) -> torch.Tensor:
    """A numpy (or numpy-convertible) array as a CPU tensor with the same
    bits, bf16 included, for copying into a parameter. It shares a
    writeable array's memory; a read-only one (JAX's) is copied first,
    since ``torch.from_numpy`` takes only writeable arrays."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    a = np.asarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: dict, cfg: LMConfig, device="cuda",
                    policy=None) -> LM:
    """The reference's parameter pytree -> an ``LM`` on ``device`` (this
    rank's shard of it under a mesh ``policy``). Raises unless every leaf
    lands on exactly one parameter of the same shape and dtype, and every
    parameter receives one leaf."""
    if policy is not None and policy.mesh is not None:
        return shard_lm(params_from_jax(tree, cfg, "cpu"), policy).to(device)
    model = LM(cfg, device)
    leaves = {name: tree[name] for name in ("embed", "head", "final_norm")}
    for name, stacked in _named_leaves(tree["layers"]).items():
        if len(stacked) != cfg.n_layers:
            raise ValueError(f"layers/{name} has {len(stacked)} layers, the "
                             f"config {cfg.n_layers}")
        for i in range(cfg.n_layers):
            leaves[f"blocks.{i}.{name}"] = stacked[i]
    _copy_leaves(model, leaves)
    return model


def _copy_leaves(model: nn.Module, leaves: dict) -> None:
    """Copy each named leaf bitwise into the parameter of that name;
    raise unless leaves and parameters pair up one to one with equal
    shapes and dtypes."""
    params = dict(model.named_parameters())
    if set(leaves) != set(params):
        raise ValueError(
            f"reference leaves without a parameter: "
            f"{sorted(set(leaves) - set(params))}; parameters without a "
            f"leaf: {sorted(set(params) - set(leaves))}")
    with torch.no_grad():
        for name, leaf in leaves.items():
            t = _tensor_from_numpy(leaf)
            p = params[name]
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: reference {t.dtype} "
                                 f"{tuple(t.shape)}, port {p.dtype} "
                                 f"{tuple(p.shape)}")
            p.copy_(t)


def _named_leaves(tree, prefix: str = "") -> dict:
    """A pytree of dicts and lists as {dotted path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_named_leaves(sub, f"{prefix}.{key}" if prefix
                                 else str(key)))
    return out


def recsys_params_from_jax(tree: dict, cfg, device="cuda",
                           policy=None) -> nn.Module:
    """The reference's recsys parameter pytree (``init_ctr_params``,
    ``init_din_params`` or ``init_twotower_params`` of ``cfg``, tables
    padded by its ``table_pad`` or not) -> the config's model on
    ``device``, its tables this rank's rows under a mesh ``policy``.
    Raises unless every leaf lands on exactly one parameter of the same
    shape and dtype (a table's rows may be padded), and every parameter
    receives one leaf."""
    model = recsys.model_for(cfg, device)
    leaves = _named_leaves(tree)
    for name in recsys.TABLES[type(model).__name__]:
        table = getattr(model, name)
        rows = np.shape(leaves.get(name, table))[0]
        if rows > table.shape[0]:               # the reference's table_pad
            setattr(model, name, nn.Parameter(table.new_empty(
                (rows,) + tuple(table.shape[1:]))))
    _copy_leaves(model, leaves)
    return recsys.shard_tables(model, policy)


def gat_params_from_jax(tree: dict, cfg: gat.GATConfig,
                        device="cuda") -> gat.GATModel:
    """The reference's GAT parameter pytree -> a ``GATModel`` on
    ``device``, leaf ``tree["layers"][i][name]`` onto ``layers.i.name``."""
    model = gat.GATModel(cfg, device)
    _copy_leaves(model, _named_leaves(tree))
    return model


# -- train states ---------------------------------------------------------


def _host(t):
    """A device tensor as a host leaf: numpy, or a CPU bf16 tensor."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _leafwise(fn, *trees):
    """``fn`` over the leaves of equally nested dicts."""
    if isinstance(trees[0], dict):
        return {k: _leafwise(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _as_lists(tree):
    """Dicts keyed 0..n-1 (from ``a.0.b`` names) as lists, as the
    reference nests an MLP's layers."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _as_lists(v) for k, v in tree.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


def _put(out: dict, name: str, leaf) -> None:
    """``out[a][b]... = leaf`` for the dotted ``name`` ``a.b...``."""
    node, parts = out, [int(p) if p.isdigit() else p
                        for p in name.split(".")]
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = leaf


class _Rule:
    """A layout rule standing as a leaf of a state's nest
    (``state_rules``)."""

    __slots__ = ("rule",)

    def __init__(self, rule):
        self.rule = tuple(rule)


def _stack_rows(*rows, leaf=_host):
    """The layers' rows as the reference's stacked leaf; one tensor held
    by every layer is the stack's leaf as it is (a row's rule, under the
    stack's leading None)."""
    if len(rows) > 1 and all(r is rows[0] for r in rows):
        return leaf(rows[0])
    if isinstance(rows[0], _Rule):
        return _Rule((None,) + rows[0].rule)
    return leaf(torch.stack(rows))


def _ref_params(named: dict, leaf=_host):
    """A parameter-keyed dict of the port -> the reference's nest, each
    leaf through ``leaf``."""
    out, stacked = {}, {}
    for name, sub in named.items():
        m = _BLOCK.fullmatch(name)
        if m:
            stacked.setdefault(m[2], {})[int(m[1])] = sub
            continue
        _put(out, name, _leafwise(leaf, sub))
    if stacked:
        layers = out["layers"] = {}
        for name, rows in stacked.items():
            _put(layers, name, _leafwise(
                lambda *r: _stack_rows(*r, leaf=leaf),
                *(rows[i] for i in range(len(rows)))))
    return _as_lists(out)


def _to_ref(tree, names: set, leaf=_host):
    if isinstance(tree, dict) and names and set(tree) == names:
        return _ref_params(tree, leaf)
    if isinstance(tree, dict):
        return {k: _to_ref(v, names, leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_ref(v, names, leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_ref(v, names, leaf) for v in tree)
    return leaf(tree)


def _meshed(policy) -> bool:
    return policy is not None and policy.mesh is not None


def _leaf_rules(sub, rule: tuple, ndim: int, memo: dict):
    """The rules of a parameter's state subtree ``sub``: a moment the
    parameter's ``rule`` (padded to its ``ndim`` dims), Adafactor's ``r``
    the rule less its last dim, ``c`` less its second to last (a 1-D
    stack's ``r`` is 0-d, its shared ``c`` has the layer's shape). A
    tensor held by several layers gets one rule object, as
    ``_stack_rows`` expects."""
    if isinstance(sub, dict):
        out = {}
        for k, t in sub.items():
            if k == "r":
                out[k] = _leaf_rules(t, rule[:-1] if t.ndim else (), t.ndim,
                                     memo)
            elif k == "c" and ndim > 1:
                out[k] = _leaf_rules(t, rule[:-2] + rule[-1:], t.ndim, memo)
            else:
                out[k] = _leaf_rules(t, rule, ndim, memo)
        return out
    return memo.setdefault(id(sub), _Rule(rule))


def _rules_tree(tree, params: dict, policy, memo: dict):
    if isinstance(tree, dict) and set(tree) == set(params):
        out = {}
        for k, sub in tree.items():
            rule = policy.param_rule(k)
            out[k] = _leaf_rules(sub, rule + (None,) * (
                params[k].ndim - len(rule)), params[k].ndim, memo)
        return out
    if isinstance(tree, dict):
        return {k: _rules_tree(v, params, policy, memo)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rules_tree(v, params, policy, memo)
                            for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rules_tree(v, params, policy, memo) for v in tree)
    return _Rule(())


def state_rules(state, policy) -> dict[str, tuple]:
    """{checkpoint path: layout rule} of every leaf of the reference's
    nest of ``state`` (``train_state_to_numpy``'s), from the parameters'
    rules the ``policy`` carries: a stacked layer leaf's rule has the
    stack's None first; the step counters are replicated."""
    from repro_torch.train.checkpoint import flatten_with_paths
    tree = _to_ref(_rules_tree(state, state.params, policy, {}),
                   set(state.params), leaf=lambda r: r)
    return {path: r.rule for path, r in flatten_with_paths(tree)}


def train_state_to_numpy(state, policy=None):
    """A port ``TrainState`` -> the reference's (``TrainState`` of the
    port's class, with the reference's nesting and numpy leaves; bf16
    leaves as CPU tensors), ready for ``train/checkpoint.save`` or for
    ``jax.tree.map(jnp.asarray, ...)``. Under a mesh ``policy`` it is a
    collective (every rank calls it): each leaf is gathered whole, in
    mesh order, onto the mesh's first rank, which gets the tree; every
    other rank sends the shards only it holds and gets None."""
    if not _meshed(policy):
        return _to_ref(state, set(state.params))
    from repro_torch.dist import collectives as coll
    from repro_torch.train.checkpoint import _unflatten, flatten_with_paths
    rules = state_rules(state, policy)
    tree = _to_ref(state, set(state.params), leaf=lambda t: t)
    leaves = [coll.gather_to_first(t.detach(), policy, rules[path])
              for path, t in flatten_with_paths(tree)]
    if any(x is None for x in leaves):
        return None
    return _unflatten(tree, iter(_host(x) for x in leaves))


def shard_cut(state, policy):
    """The elastic restore's cut for the rank's ``state`` under
    ``policy`` (``train/checkpoint.py::restore(..., cut=)``): a function
    of (checkpoint path, whole leaf as read: numpy, or a bf16 CPU tensor)
    to the rank's shard of it, of the same kind. None without a mesh."""
    if not _meshed(policy):
        return None
    rules = state_rules(state, policy)

    def cut(path, leaf):
        if not policy.sharded_over(rules[path]):
            return leaf
        part = policy.relayout(torch.as_tensor(leaf), (), rules[path])
        return part.clone() if isinstance(leaf, torch.Tensor) else \
            part.numpy().copy()
    return cut


def reference_layout(tree, names: set):
    """``tree`` (a ``TrainState``, a parameter-keyed dict or a nest holding
    one) in the reference's nesting with the port's tensors as they are
    (a layer stack as one stacked tensor): on the meta device, the
    reference's abstract pytree of a cell (``launch/cells.py``)."""
    return _to_ref(tree, names, leaf=lambda t: t)


def _walk(tree, name: str):
    for p in name.split("."):
        tree = tree[int(p) if p.isdigit() else p]
    return tree


def _ref_leaf(tree, name: str, port):
    """The reference's subtree for the port's parameter ``name``, whose
    port subtree is ``port``: row i of a stacked leaf for layer i, or the
    whole leaf where the port's tensor has the stack's own rank (a tensor
    the layers share)."""
    m = _BLOCK.fullmatch(name)
    if not m:
        return _walk(tree, name)
    i = int(m[1])
    return _leafwise(lambda a, p: a if len(a.shape) == p.ndim else a[i],
                     _walk(tree["layers"], m[2]), port)


@torch.no_grad()
def _fill(port, ref) -> None:
    """Copy ``ref``'s leaves into the port's tensors of the same nest."""
    if isinstance(port, dict):
        for k in port:
            _fill(port[k], ref[k])
        return
    t = _tensor_from_numpy(ref)
    if t.shape != port.shape or t.dtype != port.dtype:
        raise ValueError(f"reference leaf {t.dtype} {tuple(t.shape)} for "
                         f"port {port.dtype} {tuple(port.shape)}")
    port.copy_(t)


def _from_ref(port, ref, names: set) -> None:
    if isinstance(port, dict) and names and set(port) == names:
        for name, sub in port.items():
            _fill(sub, _ref_leaf(ref, name, sub))
    elif isinstance(port, dict):
        if set(port) != set(ref):
            raise ValueError(f"state keys {sorted(port)} != reference "
                             f"{sorted(ref)}")
        for k in port:
            _from_ref(port[k], ref[k], names)
    elif isinstance(port, (list, tuple)):
        if len(port) != len(ref):
            raise ValueError(f"{len(port)} state entries, reference "
                             f"{len(ref)}")
        for a, b in zip(port, ref):
            _from_ref(a, b, names)
    else:
        _fill(port, ref)


def train_state_from_jax(tree, state):
    """Copy a reference ``TrainState`` (its params, opt_state and step as
    numpy, e.g. ``jax.device_get`` of it or a restored checkpoint) into
    the port's ``state`` in place: the model's parameters, the optimizer's
    buffers and the step. ``state`` gives the port's layout (a model's
    parameters and ``optimizer.init`` of them); under a mesh ``tree``
    holds the rank's shards (``checkpoint.restore(..., cut=shard_cut(
    state, policy))``). Raises unless every leaf lands on a tensor of the
    same shape and dtype. Returns ``state``."""
    _from_ref(state, tree, set(state.params))
    return state

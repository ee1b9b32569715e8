"""Optimizers as plain functions (no ``torch.optim``): AdamW, Adafactor,
SGD-momentum, global-norm clipping, and a composable transform interface.

Twin of ``src/repro/train/optimizer.py``. Parameters, gradients and
updates are flat ``dict[str, Tensor]``s keyed by parameter name (a
model's ``named_parameters()``); a state is a dict (or, for ``chain``, a
tuple) with the reference's key names (``m``, ``v``, ``step``, ``r``,
``c``, ``full``, ``mom``), so ``models/convert.py`` maps it onto the
reference's pytree. The update math is the reference's, op for op: moments
in float32 whatever the parameter dtype, Adafactor's first moment in
bfloat16, bias correction from an int32 step counter.

An LM's parameters are per layer (``blocks.{i}.{path}``) where the
reference's are (L, ...) stacks (``layers/{path}``). Where a statistic
spans a whole leaf (Adafactor's factoring and update-RMS clip,
``train/compression.py``'s int8 scale) it spans the stack: the names are
grouped by ``layer_stacks``, the rule ``models/convert.py`` stacks them by
for checkpoints.

Under a mesh (explicit SPMD, ``models/transformer.py``) each rank holds
its shard of every parameter, and of its gradient and moments. The
statistics that span a leaf span the whole leaf, as GSPMD gives the
reference: ``global_norm``, ``clip_by_global_norm`` and ``adafactor``
take the ``policy``, which carries each name's layout rule
(``ShardingPolicy.with_params``), and reduce over the axes a leaf is
sharded on: the squares of ``global_norm`` are summed there (a
replicated leaf counted once), Adafactor's factored means over a sharded
dim are ``pmean``'d, and its update-RMS clip is a ``psum`` of local sums
over the global count. AdamW and SGD are elementwise and need neither.
The gradients must already be reduced (``trainer.make_train_step(...,
policy=)``), so a replicated leaf's is the same on every rank.

``update(grads, state, params)`` returns ``(updates, state)``. It writes
the new moments into the state's own buffers, so the state passed in is
consumed: the reference's train loop donates its state the same way
(``jax.jit(step, donate_argnums=0)``). ``torch.optim.AdamW`` is not used
because it folds weight decay in as ``p *= 1 - lr * wd`` before the Adam
step, where the reference adds ``wd * p`` to the Adam direction.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, NamedTuple

import torch


# an LM's per-layer parameter: row int(m[1]) of the reference's stacked
# leaf layers/m[2] (m[2] dotted where the leaf is nested: "moe.router")
LAYER_LEAF = re.compile(r"blocks\.(\d+)\.(.+)")


def layer_stacks(names) -> list[list[str]]:
    """``names`` grouped as the reference's leaves: the ``blocks.{i}.{path}``
    of one path form one group, in layer order; any other name is a group
    of its own. Groups come in the order of their first name."""
    groups: dict[tuple[str, str], list[tuple[int, str]]] = {}
    for name in names:
        m = LAYER_LEAF.fullmatch(name)
        key = ("layers", m[2]) if m else ("", name)
        groups.setdefault(key, []).append((int(m[1]) if m else 0, name))
    return [[n for _, n in sorted(g)] for g in groups.values()]


class Optimizer(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], tuple[dict, Any]]  # (g, state, p)
    #                                                        -> (updates,
    #                                                            state)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """``p + u.to(p.dtype)`` written into each parameter in place (a
    bfloat16 parameter adds the bfloat16-rounded update, as the reference
    does). Returns ``params``."""
    for name, p in params.items():
        p.add_(updates[name].to(p.dtype))
    return params


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _meshed(policy) -> bool:
    return policy is not None and policy.mesh is not None


def _dim_axes(policy, rule, ndim: int, dim: int) -> tuple[str, ...]:
    """The mesh axes (of more than one rank) that dim ``dim`` of a leaf of
    ``ndim`` dims is tiled over under ``rule`` (trailing dims absent from
    a rule are replicated)."""
    axes = policy.axes(tuple(rule) + (None,) * (ndim - len(rule)))[dim]
    return tuple(a for a in axes if policy.axis_size(a) > 1)


def _pmean(x: torch.Tensor, policy, axes) -> torch.Tensor:
    if not axes:
        return x
    from repro_torch.dist import collectives as coll
    return coll.pmean(x, policy, axes)


def global_norm(tree: dict, policy=None) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed leaf by leaf in the
    dict's order. Under a mesh ``policy`` each leaf is the rank's shard in
    layout ``policy.param_rule(name)``: the local sums of the leaves
    sharded over the same axes are added, then ``psum``'d over those
    axes, so each leaf counts once (a replicated leaf is the same on
    every rank)."""
    if not _meshed(policy):
        total = 0
        for x in tree.values():
            total = total + _f32(x).square().sum()
        return torch.sqrt(total)
    from repro_torch.dist import collectives as coll
    groups: dict[tuple, torch.Tensor] = {}
    for name, x in tree.items():
        axes = policy.sharded_over(policy.param_rule(name))
        groups[axes] = groups.get(axes, 0) + _f32(x).square().sum()
    total = 0
    for axes, part in groups.items():
        total = total + (coll.psum(part, policy, axes) if axes else part)
    return torch.sqrt(total)


def _step_of(state) -> tuple[torch.Tensor, torch.Tensor]:
    step = state["step"] + 1
    return step, step.to(torch.float32)


def clip_by_global_norm(max_norm: float, *, policy=None) -> Optimizer:
    """Scale the gradients so their global norm is at most ``max_norm``;
    under a mesh the norm of the whole leaves (``global_norm``)."""
    def init(params):
        del params
        return ()

    def update(grads, state, params=None):
        del params
        g = global_norm(grads, policy)
        scale = torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0)
        # a bf16 gradient times the float32 scale is float32, as jnp
        # promotes it
        return {k: _f32(x) * scale for k, x in grads.items()}, state

    return Optimizer(init, update)


def adamw(lr: float | Callable[[torch.Tensor], torch.Tensor], *,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW (decoupled weight decay). ``lr`` may be a schedule of the
    step (an int32 tensor)."""

    def init(params):
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return {"m": zeros,
                "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
                "step": torch.zeros((), dtype=torch.int32,
                                    device=_device(params))}

    @torch.no_grad()
    def update(grads, state, params):
        step, step_f = _step_of(state)
        lr_t = lr(step) if callable(lr) else lr
        b1t = 1.0 - b1 ** step_f
        b2t = 1.0 - b2 ** step_f
        updates = {}
        for k, g in grads.items():
            g = _f32(g)
            m, v = state["m"][k], state["v"][k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            mh = m / b1t
            vh = v / b2t
            updates[k] = -lr_t * (mh / (torch.sqrt(vh) + eps)
                                  + weight_decay * _f32(params[k]))
        return updates, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update)


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def adafactor(lr: float | Callable = 1e-3, *, b1: float | None = 0.9,
              decay: float = 0.999, eps: float = 1e-30,
              clip_threshold: float = 1.0,
              momentum_dtype=torch.bfloat16, policy=None) -> Optimizer:
    """Adafactor (Shazeer & Stern 2018): for a leaf of two or more axes
    the second moment is kept as row and column means (``r``, ``c``);
    other leaves keep it whole (``full``). The first moment is kept in
    ``momentum_dtype`` (bfloat16; ``b1=None`` drops it).

    Statistics span the reference's leaves: an LM's per-layer parameters
    are taken as their (L, ...) stack (``layer_stacks``). The update-RMS
    clip is one mean over the stack. A stack of 2-D+ layers factors only
    its last two axes, so each layer keeps its own ``r`` and ``c``; a
    stack of 1-D layers (norm scales, biases) is factored as (L, d): layer
    i keeps ``r`` as a 0-d tensor (row i of the reference's (L,)) and
    every layer holds the one ``c`` (d,) tensor.

    Under a mesh ``policy`` (carrying each name's layout rule) a mean
    over a sharded dim is the local mean ``pmean``'d over that dim's axes
    (the shards are equal): ``r`` of a column-parallel leaf, ``c`` and
    ``denom`` of a row-parallel or vocabulary-row leaf; the update-RMS
    clip's mean is a ``psum`` of the local sums over the leaf's sharded
    axes, over the global count."""
    meshed = _meshed(policy)

    def leaf_shape(name, p):
        """The whole leaf's shape of the rank's ``p`` (its own without a
        mesh): factoring is decided on the reference's shapes."""
        if not meshed:
            return tuple(p.shape)
        rule = policy.param_rule(name)
        axes = policy.axes(rule + (None,) * (p.ndim - len(rule)))
        return tuple(n * policy.axes_size(a) for n, a in zip(p.shape, axes))

    def dim_axes(name, ndim, dim, stacked=False):
        if not meshed:
            return ()
        rule = policy.param_rule(name)
        return _dim_axes(policy, (None,) + rule if stacked else rule,
                         ndim, dim)

    def zeros(shape, device):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def init(params):
        v = {}
        for group in layer_stacks(params):
            p = params[group[0]]
            # the reference's leaf: (L,) + the layer's shape for a stack
            shape = ((len(group),) if LAYER_LEAF.fullmatch(group[0])
                     else ()) + leaf_shape(group[0], p)
            if len(group) > 1 and p.ndim == 1 and _factored(shape):
                c = zeros(p.shape, p.device)          # shared by the layers
                v.update({k: {"r": zeros((), p.device), "c": c}
                          for k in group})
                continue
            for k in group:
                p = params[k]
                v[k] = ({"r": zeros(p.shape[:-1], p.device),
                         "c": zeros(p.shape[:-2] + p.shape[-1:], p.device)}
                        if _factored(shape) else
                        {"full": zeros(p.shape, p.device)})
        state = {"v": {k: v[k] for k in params},
                 "step": torch.zeros((), dtype=torch.int32,
                                     device=_device(params))}
        if b1 is not None:
            state["m"] = {k: torch.zeros(p.shape, dtype=momentum_dtype,
                                         device=p.device)
                          for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(grads, state, params):
        del params
        step, step_f = _step_of(state)
        lr_t = lr(step) if callable(lr) else lr
        # the beta2 schedule, capped by the configured decay
        beta2 = torch.clamp(1.0 - step_f ** -0.8, max=decay)

        def second_moment(v, g2, name, stacked=False):
            """Update v in place from g2; returns vhat."""
            if "r" in v:
                last = dim_axes(name, g2.ndim, -1, stacked)
                rows = dim_axes(name, g2.ndim, -2, stacked)
                v["r"].mul_(beta2).add_((1 - beta2) * _pmean(
                    g2.mean(dim=-1), policy, last))
                v["c"].mul_(beta2).add_((1 - beta2) * _pmean(
                    g2.mean(dim=-2), policy, rows))
                denom = torch.clamp(_pmean(v["r"].mean(dim=-1, keepdim=True),
                                           policy, rows), min=eps)
                return (v["r"][..., None] * v["c"][..., None, :]
                        ) / denom[..., None]
            return v["full"].mul_(beta2).add_((1 - beta2) * g2)

        updates = {}
        for group in layer_stacks(grads):
            gs = [_f32(grads[k]) for k in group]
            vs = [state["v"][k] for k in group]
            if len(group) > 1 and gs[0].ndim == 1 and "r" in vs[0]:
                # a 1-D stack, factored as the reference's (L, d) leaf
                g = torch.stack(gs)
                v = {"r": torch.stack([v["r"] for v in vs]),
                     "c": vs[0]["c"]}
                u = g * torch.rsqrt(second_moment(
                    v, g * g + eps, group[0], stacked=True) + eps)
                for vi, r in zip(vs, v["r"]):
                    vi["r"].copy_(r)
                us = list(u)
            else:
                us = [g * torch.rsqrt(second_moment(v, g * g + eps, k) + eps)
                      for g, v, k in zip(gs, vs, group)]
            # relative update clipping, by the RMS over the whole leaf
            sharded = (policy.sharded_over(policy.param_rule(group[0]))
                       if meshed else ())
            if len(us) == 1 and not sharded:
                ms = (us[0] * us[0]).mean()
            else:
                ss = torch.stack([(u * u).sum() for u in us]).sum()
                count = sum(u.numel() for u in us)
                if sharded:
                    from repro_torch.dist import collectives as coll
                    ss = coll.psum(ss, policy, sharded)
                    count *= policy.axes_size(sharded)
                ms = ss / count
            rms_u = torch.sqrt(ms + 1e-12)
            for k, u in zip(group, us):
                u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
                if b1 is not None:
                    m = state["m"][k]
                    m.copy_(b1 * m.to(torch.float32) + (1 - b1) * u)
                    u = m.to(torch.float32)
                updates[k] = -lr_t * u
        updates = {k: updates[k] for k in grads}
        new_state = {"v": state["v"], "step": step}
        if b1 is not None:
            new_state["m"] = state["m"]
        return updates, new_state

    return Optimizer(init, update)


def zero1_rule(shape, policy) -> tuple:
    """ZeRO-1's layout of a leaf of the whole ``shape``
    (``cells.py:146-158``): tiled over every mesh axis, in mesh order, on
    its first dim that the device count divides; replicated (``()``)
    when none does."""
    from repro_torch.dist.policy import _spec
    n = policy.device_count
    axes = tuple(policy.mesh.mesh_dim_names)
    for i, d in enumerate(shape):
        if d > 0 and d % n == 0:
            return _spec(*((None,) * i + (axes,)))
    return ()


def zero1_rules(params: dict, policy) -> dict[str, tuple]:
    """Each whole parameter's ZeRO-1 rule by name: the layout its
    moments are held in (``zero1``)."""
    return {k: zero1_rule(tuple(p.shape), policy) for k, p in params.items()}


def zero1(inner: Optimizer, policy) -> Optimizer:
    """ZeRO-1 over ``policy``'s mesh (the reference's ``variant="zero1"``:
    ``_zero1_opt_specs``): the parameters and their gradients whole on
    every rank (the gradients summed already, ``trainer.reduce_grads``),
    each optimizer-state leaf only the rank's shard.

    ``policy`` carries each parameter's ZeRO-1 rule (``policy.
    with_params(zero1_rules(params, policy))``) and ``inner`` is built
    with the same policy, so it reads each parameter as sharded by that
    rule: ``update`` cuts every gradient (and parameter) to the rank's
    slice, runs ``inner`` on the slices, where every statistic over a
    whole leaf is a collective (``global_norm``'s ``psum``, Adafactor's
    ``pmean``'d factored means and ``psum``'d update RMS: PORT.md, "The
    cells under a mesh"), and all-gathers the sliced updates into whole
    ones. A state leaf is stored as ``zero1_rule`` of its own whole shape
    says; where that differs from the layout ``inner`` keeps it in
    (Adafactor's column statistic ``c`` of a leaf sharded on its rows:
    ZeRO-1 shards ``c`` on its own dim), ``update`` gathers the small
    vector for ``inner`` and keeps the rank's slice of the new one."""
    def cut(tree):
        return {k: policy.relayout(v, (), policy.param_rule(k))
                for k, v in tree.items()}

    def layouts(state, params_local):
        """[(path, inner rule, stored rule)] of the state leaves whose
        stored layout differs from ``inner``'s."""
        from repro_torch.models import convert
        rules = convert._rules_tree(state, params_local, policy, {})
        out = []

        def walk(node, rule, path):
            if isinstance(node, torch.Tensor):
                axes = policy.axes(rule.rule + (None,) * (
                    node.ndim - len(rule.rule)))
                whole = tuple(n * policy.axes_size(a)
                              for n, a in zip(node.shape, axes))
                stored = zero1_rule(whole, policy)
                if policy.axes(stored) + ((),) * (node.ndim - len(stored)) \
                        != axes:
                    out.append((path, rule.rule, stored))
                return
            items = (node.items() if isinstance(node, dict)
                     else enumerate(node))
            for k, sub in items:
                walk(sub, rule[k], path + (k,))

        walk(state, rules, ())
        return out

    def swap(state, diffs, src: int, dst: int):
        """Relayout the leaves of ``diffs`` from their ``src`` rule to
        their ``dst`` rule (0 inner, 1 stored), in place in ``state``'s
        dicts; a tensor several paths share moves once."""
        moved = {}
        for path, *rules in diffs:
            node = state
            for k in path[:-1]:
                node = node[k]
            t = node[path[-1]]
            if id(t) not in moved:
                moved[id(t)] = policy.relayout(t, rules[src],
                                               rules[dst]).clone()
            node[path[-1]] = moved[id(t)]

    def diffs_of(local):
        """``layouts`` of ``inner``'s state of the rank's slices, read on
        the meta device (a state in the stored layout hides the inner
        shapes)."""
        meta = {k: torch.empty_like(v, device="meta")
                for k, v in local.items()}
        return layouts(inner.init(meta), meta)

    def init(params):
        local = cut(params)
        state = inner.init(local)
        swap(state, diffs_of(local), 0, 1)
        return state

    @torch.no_grad()
    def update(grads, state, params):
        local = cut(params)
        diffs = diffs_of(local)
        swap(state, diffs, 1, 0)
        updates, state = inner.update(cut(grads), state, local)
        swap(state, diffs, 0, 1)
        return {k: policy.relayout(u, policy.param_rule(k), ())
                for k, u in updates.items()}, state

    return Optimizer(init, update)


def sgd(lr: float, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return {"mom": {k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params=None):
        del params
        mom = state["mom"]
        for k, g in grads.items():
            mom[k].mul_(momentum).add_(_f32(g))
        return {k: -lr * m for k, m in mom.items()}, {"mom": mom}

    return Optimizer(init, update)


def chain(*opts: Optimizer) -> Optimizer:
    """Sequentially-composed gradient transforms (clip -> adam, etc.)."""

    def init(params):
        return tuple(o.init(params) for o in opts)

    def update(grads, state, params):
        new_states = []
        for o, s in zip(opts, state):
            grads, s = o.update(grads, s, params)
            new_states.append(s)
        return grads, tuple(new_states)

    return Optimizer(init, update)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``floor * peak_lr`` at ``total``: a function of the int32 step."""
    def lr(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def _device(params: dict) -> torch.device:
    for p in params.values():
        return p.device
    return torch.device("cpu")

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

It reads numpy only: a JAX array passes through ``np.asarray``, and a
bf16 array arrives as numpy dtype ``bfloat16`` (``ml_dtypes``), which
``torch.from_numpy`` rejects; it travels as its ``uint16`` bits instead.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models import recsys
from repro_torch.models.transformer import LM, LMConfig


def _tensor_from_numpy(a) -> torch.Tensor:
    """A numpy (or numpy-convertible) array as a CPU tensor with the same
    bits, bf16 included (copied: JAX's arrays are read-only)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree: dict, cfg: LMConfig, device="cuda") -> LM:
    """The reference's parameter pytree -> an ``LM`` on ``device``.
    Raises unless every leaf lands on exactly one parameter of the same
    shape and dtype, and every parameter receives one leaf."""
    model = LM(cfg, device)
    leaves = {name: tree[name] for name in ("embed", "head", "final_norm")}
    for name, stacked in tree["layers"].items():
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


def recsys_params_from_jax(tree: dict, cfg, device="cuda") -> nn.Module:
    """The reference's recsys parameter pytree (``init_ctr_params``,
    ``init_din_params`` or ``init_twotower_params`` of ``cfg``, tables
    unpadded) -> the config's model on ``device``. Raises unless every
    leaf lands on exactly one parameter of the same shape and dtype, and
    every parameter receives one leaf."""
    model = recsys.model_for(cfg, device)
    _copy_leaves(model, _named_leaves(tree))
    return model

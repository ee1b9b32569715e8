"""The reference's LM parameters into the port's ``LM`` module.

``params_from_jax`` takes the pytree of ``repro.models.transformer.
init_params`` (or a checkpoint of it) as numpy arrays, layer leaves with
their leading (L,) axis, and copies each leaf into exactly one parameter
of an ``LM``: ``tree["layers"][name][i]`` into ``model.blocks[i].<name>``,
and ``embed``, ``head`` and ``final_norm`` as they are. Both sides keep
the (in, out) layout, so the copy is bitwise.

It reads numpy only: a JAX array passes through ``np.asarray``, and a
bf16 array arrives as numpy dtype ``bfloat16`` (``ml_dtypes``), which
``torch.from_numpy`` rejects; it travels as its ``uint16`` bits instead.
"""

from __future__ import annotations

import numpy as np
import torch

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
    return model

"""int8 error-feedback gradient compression (the 1-bit-Adam family's
trick).

Twin of ``src/repro/train/compression.py:24-78``. Wrapping an optimizer,
each gradient leaf is quantized to int8 with a per-leaf scale before the
update (a leaf as the reference has it: an LM's per-layer gradients share
the one scale of their (L, ...) stack, ``optimizer.layer_stacks``); the
quantization error is kept in a residual buffer and added back the next
step, which keeps the compressed optimizer convergent (Seide et al. 2014,
Tang et al. 2021).

``compressed_psum`` is the reference's collective (``compression.py:
36-50``) on a ``ShardingPolicy``'s mesh axes: the sum over those axes of
int8 payloads quantized at one shared scale, added in int32.
"""

from __future__ import annotations

import torch

from repro_torch.train.optimizer import Optimizer, layer_stacks


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: CUDA divides by a Python scalar as a product with
    # its rounded reciprocal, one ulp off the reference's division
    return torch.clamp(amax, min=1e-12) / amax.new_tensor(127.0)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x float32 -> (q int8, scale float32 scalar); the scale maps 127 to
    max|x|. Rounds half to even, as ``jnp.round``."""
    scale = _scale_of(x.abs().max())
    return _quantize(x, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum(x: torch.Tensor, policy, axes) -> torch.Tensor:
    """The sum of ``x`` over the mesh axes ``axes`` (a name or a tuple) at
    int8 precision, ``x`` taken in float32 (the reference's float32
    gradients): every rank quantizes at the shared scale ``s_max =
    pmax(max(max|x|, 1e-12) / 127)``, the int8 values are summed in int32
    (exact for up to 2**24 ranks) and the sum dequantized, ``total *
    s_max``. The result is the same on every rank along ``axes``, within
    ``n_ranks * s_max / 2`` of the float sum. No gradient flows through
    it: it reduces gradients, it is not differentiated."""
    from repro_torch.dist import collectives as coll
    xf = x.detach().to(torch.float32)
    s_max = coll.pmax(_scale_of(xf.abs().max()), policy, axes)
    q = _quantize(xf, s_max)
    total = coll.psum(q.to(torch.int32), policy, axes)
    return total.to(torch.float32) * s_max


def error_feedback(inner: Optimizer) -> Optimizer:
    """Error-feedback int8 compression around an optimizer's gradient
    input. State: ``residual`` (float32, one per parameter) and ``inner``.
    The scale is ``max|g + residual|`` over the reference's leaf: over
    every layer of an LM's stack."""

    def init(params):
        return {"residual": {k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()},
                "inner": inner.init(params)}

    @torch.no_grad()
    def update(grads, state, params):
        comp, resid = {}, state["residual"]
        for group in layer_stacks(grads):
            gs = [grads[k].to(torch.float32) + resid[k] for k in group]
            scale = _scale_of(torch.stack([g.abs().max() for g in gs]).max())
            for k, g in zip(group, gs):
                deq = dequantize_int8(_quantize(g, scale), scale)
                comp[k] = deq
                resid[k] = g - deq
        comp = {k: comp[k] for k in grads}
        updates, inner_state = inner.update(comp, state["inner"], params)
        return updates, {"residual": resid, "inner": inner_state}

    return Optimizer(init, update)

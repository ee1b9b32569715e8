"""int8 error-feedback gradient compression (the 1-bit-Adam family's
trick).

Twin of ``src/repro/train/compression.py:24-78``. Wrapping an optimizer,
each gradient leaf is quantized to int8 with a per-leaf scale before the
update; the quantization error is kept in a residual buffer and added back
the next step, which keeps the compressed optimizer convergent (Seide et
al. 2014, Tang et al. 2021).

The reference's ``compressed_psum`` (quantize, psum in int32 over a mesh
axis, dequantize) is a collective; it waits for the multi-GPU slice of
the port (ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.train.optimizer import Optimizer


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x float32 -> (q int8, scale float32 scalar); the scale maps 127 to
    max|x|. Rounds half to even, as ``jnp.round``."""
    amax = x.abs().max()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def error_feedback(inner: Optimizer) -> Optimizer:
    """Error-feedback int8 compression around an optimizer's gradient
    input. State: ``residual`` (float32, one per leaf) and ``inner``."""

    def init(params):
        return {"residual": {k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()},
                "inner": inner.init(params)}

    @torch.no_grad()
    def update(grads, state, params):
        comp, resid = {}, state["residual"]
        for k, g in grads.items():
            g = g.to(torch.float32) + resid[k]
            deq = dequantize_int8(*quantize_int8(g))
            comp[k] = deq
            resid[k] = g - deq
        updates, inner_state = inner.update(comp, state["inner"], params)
        return updates, {"residual": resid, "inner": inner_state}

    return Optimizer(init, update)

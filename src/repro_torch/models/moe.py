"""Mixture-of-Experts FFN: top-k routing, sort-based capacity dispatch,
grouped expert GEMMs and the Switch load-balance loss.

Twin of ``src/repro/models/moe.py`` on its mesh-less path, which the
reference calls "the identical code path minus the collectives". Dispatch
is MegaBlocks-style: the (token, choice) assignments are sorted by expert
id (a stable sort), each one's position within its expert comes from
``searchsorted``, and an assignment whose position reaches the capacity is
dropped. Every shape is static and the largest buffer is (E * C, D).

Contracts kept from the reference, op for op:

- the router is float32 whatever the model dtype, and so are its logits,
  softmax and gates; the expert weights and the combine are in the model
  dtype;
- top-k breaks equal probabilities toward the lower expert id, as
  ``lax.top_k`` does (``kernels/ref.py::topk_stable``; ``torch.topk``
  promises no order);
- gates are the top-k probabilities over their sum, floored at 1e-9;
- the capacity is ``max(top_k, int(capacity_factor * T * top_k / E))``,
  so it grows with the T = B * S tokens of a call: the same token may be
  dropped in a long batch and kept in a short one. Among one expert's
  assignments the stable sort keeps the earliest (token-major) and drops
  the last;
- the aux loss ``E * sum_e frac_tokens_e * frac_probs_e`` counts every
  assignment in ``frac_tokens``, dropped ones included.

Expert parallelism (``moe_ffn(..., policy)`` under a mesh whose "model"
axis has more than one rank; the reference's ``shard_map`` +
``all_to_all`` path, ``moe.py:138-196``) is explicit SPMD: each rank holds
the experts of its "model" coordinate (``p_expert_in``/``p_expert_out``:
E / tp of them, contiguous) and its own tokens, those of the residual's
layout (``act_btd``: the sequence-parallel shard in prefill, the batch
in decode). It routes and dispatches them at **the local capacity**
``expert_capacity(cfg, T_local)``, exchanges the (E, C, D) buffer for
(E_local, C * tp, D) by one ``all_to_all`` over "model", runs its
experts, sends the rows home by a second ``all_to_all`` and combines; the
aux loss is the ``pmean`` over "model" and the data axes. Since the
capacity is per shard, an answer under a mesh differs from one device's
where an expert overflows (as in the reference); with nothing dropped
they agree. Under autograd (slice 17) the same path is the backward's:
each ``all_to_all`` sends the gradient rows back by the transposed
exchange, a dropped assignment's row is the cut spare row, so it gets no
gradient, and the ``pmean``'d aux hands every rank the full gradient of
its own share (``dist/collectives.py``); the router's gradient is the
rank's share, summed by the trainer.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.dist.policy import TP_AXIS_NAME
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25


class MoE(nn.Module):
    """One layer's experts, named as the reference's ``moe`` pytree:
    ``router`` (D, E) float32, ``w_in`` and ``w_gate`` (E, D, F), ``w_out``
    (E, F, D) in ``dtype``. ``moe(x, cfg)`` runs ``moe_ffn``: the config
    comes with the call (an LM passes its own ``cfg.moe``), so forward
    hooks see each call's input."""

    def __init__(self, d_model: int, cfg: MoEConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        e, f = cfg.n_experts, cfg.d_ff_expert

        def p(*shape, dt=dtype):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=device))

        self.router = p(d_model, e, dt=torch.float32)
        self.w_in, self.w_gate = p(e, d_model, f), p(e, d_model, f)
        self.w_out = p(e, f, d_model)

    def forward(self, x: torch.Tensor, cfg: MoEConfig, policy=None):
        return moe_ffn(x, self, cfg, policy)


def draws(d_model: int, d_ff_expert: int) -> tuple[tuple[str, float], ...]:
    """(parameter, scale) of an MoE layer's draws, in the order the
    generator draws them: each matrix N(0, 1) times fan_in^-0.5."""
    d, f = d_model, d_ff_expert
    return (("router", d ** -0.5), ("w_in", d ** -0.5),
            ("w_gate", d ** -0.5), ("w_out", f ** -0.5))


@torch.no_grad()
def draw_moe_params_(moe: MoE, generator: torch.Generator) -> MoE:
    """Fill ``moe`` in place at the reference's scales (``draws``), drawn
    in float32 on the generator's device and cast to its parameter's
    dtype (the router stays float32)."""
    for name, scale in draws(moe.w_in.shape[1], moe.w_in.shape[2]):
        param = getattr(moe, name)
        x = torch.randn(param.shape, generator=generator,
                        device=generator.device, dtype=torch.float32)
        param.copy_((x * scale).to(param.dtype))
    return moe


def init_moe_params(generator: torch.Generator, d_model: int,
                    cfg: MoEConfig, dtype=torch.float32,
                    device="cuda") -> MoE:
    """A ``MoE`` on ``device`` with weights drawn from ``generator``. The
    draws are torch's, not JAX's: to hold the port against the reference,
    load the reference's arrays (``MoE.load_state_dict``)."""
    return draw_moe_params_(MoE(d_model, cfg, dtype, device), generator)


def expert_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Dispatch-buffer rows per expert for a call over ``n_tokens``."""
    return max(cfg.top_k, int(cfg.capacity_factor * n_tokens * cfg.top_k
                              / cfg.n_experts))


def _dispatch_indices(expert_ids: torch.Tensor, n_experts: int,
                      capacity: int):
    """Sort-based dispatch. expert_ids (A,) -> (slot (A,), keep (A,)).

    slot[a] in [0, n_experts * capacity) is the dispatch-buffer row of
    assignment a; keep[a] is False for over-capacity (dropped)
    assignments."""
    a = expert_ids.shape[0]
    order = torch.argsort(expert_ids, stable=True)
    sorted_e = expert_ids[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(n_experts, dtype=sorted_e.dtype,
                               device=sorted_e.device))
    pos_sorted = torch.arange(a, device=sorted_e.device) - starts[sorted_e]
    keep_sorted = pos_sorted < capacity
    slot_sorted = sorted_e * capacity + torch.clamp(pos_sorted,
                                                    max=capacity - 1)
    # back to assignment order: the inverse permutation, as a scatter
    slot, keep = torch.empty_like(slot_sorted), torch.empty_like(keep_sorted)
    slot[order] = slot_sorted
    keep[order] = keep_sorted
    return slot, keep


def route(x2d: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
          capacity: int):
    """The routing of x2d (T, D): (probs (T, E) float32, top_e (T, k)
    int64, gates (T, k) float32, slot (T*k,), keep (T*k,))."""
    logits = x2d.to(torch.float32) @ router                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = kref.topk_stable(probs, cfg.top_k)          # (T, k)
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    slot, keep = _dispatch_indices(top_e.reshape(-1), cfg.n_experts,
                                   capacity)
    return probs, top_e, gates, slot, keep


def _expert_ffn(buf: torch.Tensor, w_in, w_gate, w_out) -> torch.Tensor:
    """Grouped SwiGLU: buf (E, C, D) -> (E, C, D)."""
    h = torch.bmm(buf, w_in)
    g = torch.bmm(buf, w_gate)
    return torch.bmm(torch.nn.functional.silu(g) * h, w_out)


def _dispatch(x2d: torch.Tensor, router: torch.Tensor, cfg: MoEConfig,
              capacity: int):
    """Route x2d (T, D) and scatter its rows into the (E, C, D) buffer ->
    (buf, probs, flat_e, gates, slot, keep)."""
    t, d = x2d.shape
    e, k = cfg.n_experts, cfg.top_k
    probs, top_e, gates, slot, keep = route(x2d, router, cfg, capacity)
    token_of = torch.arange(t * k, device=x2d.device) // k
    # dropped assignments write one spare row past the buffer, which is cut
    # off: the reference's .at[...].set(mode="drop"), without a host sync
    buf = x2d.new_zeros((e * capacity + 1, d))
    buf[torch.where(keep, slot, e * capacity)] = x2d[token_of]
    return (buf[:-1].reshape(e, capacity, d), probs, top_e.reshape(-1),
            gates, slot, keep)


def _combine(out_buf: torch.Tensor, gates, slot, keep, cfg: MoEConfig,
             dtype) -> torch.Tensor:
    """The (E, C, D) expert outputs gathered back to their assignments
    and summed with the gates -> (T, D)."""
    d = out_buf.shape[-1]
    rows = out_buf.reshape(-1, d)[slot]                        # (T*k, D)
    rows = torch.where(keep[:, None], rows, 0.0)
    return torch.sum(rows.reshape(-1, cfg.top_k, d)
                     * gates[..., None].to(dtype), dim=1)


def _aux(flat_e: torch.Tensor, probs: torch.Tensor, e: int) -> torch.Tensor:
    """The load-balance loss (Switch Transformer eq. 4); the one-hot mean,
    as the reference takes it (torch.bincount would sync with the
    host)."""
    frac_tokens = (flat_e[:, None] == torch.arange(
        e, device=flat_e.device)).to(torch.float32).mean(dim=0)
    return e * torch.sum(frac_tokens * probs.mean(dim=0))


def _moe_local(x2d: torch.Tensor, params: MoE, cfg: MoEConfig,
               capacity: int, stats: dict | None = None):
    """Route + dispatch + expert FFN + combine for x2d (T, D) over all
    ``cfg.n_experts`` experts -> (combined (T, D), aux ())."""
    buf, probs, flat_e, gates, slot, keep = _dispatch(
        x2d, params.router, cfg, capacity)
    out_buf = _expert_ffn(buf, params.w_in, params.w_gate,
                          params.w_out)                        # (E, C, D)
    _record(stats, keep, capacity)
    return (_combine(out_buf, gates, slot, keep, cfg, x2d.dtype),
            _aux(flat_e, probs, cfg.n_experts))


def _record(stats: dict | None, keep: torch.Tensor, capacity: int) -> None:
    if stats is not None:
        stats.update(dropped=(~keep).sum(), assigned=keep.numel(),
                     capacity=capacity)


def _moe_ep(x2d: torch.Tensor, params: MoE, cfg: MoEConfig, policy,
            stats: dict | None = None):
    """Expert parallelism over "model" for this rank's tokens x2d (T, D)
    and its experts (module docstring) -> (combined (T, D), aux ())."""
    from repro_torch.dist import collectives as coll
    tp = policy.model_axis_size
    if cfg.n_experts % tp or params.w_in.shape[0] != cfg.n_experts // tp:
        raise ValueError(f"expert parallelism over {tp} ranks: "
                         f"{cfg.n_experts} experts, this rank holds "
                         f"{params.w_in.shape[0]} (want the rank's "
                         f"{cfg.n_experts // tp})")
    capacity = expert_capacity(cfg, x2d.shape[0])
    buf, probs, flat_e, gates, slot, keep = _dispatch(
        x2d, params.router, cfg, capacity)
    # (E, C, D) -> (E_local, C * tp, D): every rank's rows for my experts
    buf = coll.all_to_all(buf, policy, TP_AXIS_NAME, split_axis=0,
                          concat_axis=1)
    out_buf = _expert_ffn(buf, params.w_in, params.w_gate, params.w_out)
    out_buf = coll.all_to_all(out_buf, policy, TP_AXIS_NAME, split_axis=1,
                              concat_axis=0)
    _record(stats, keep, capacity)
    aux = coll.pmean(_aux(flat_e, probs, cfg.n_experts), policy,
                     (TP_AXIS_NAME,) + policy.dp_axes())
    return _combine(out_buf, gates, slot, keep, cfg, x2d.dtype), aux


def moe_ffn(x: torch.Tensor, params: MoE, cfg: MoEConfig, policy=None, *,
            stats: dict | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN over (B, S, D) activations -> (out (B, S, D), aux ()).
    Under a mesh with a "model" axis of more than one rank: expert
    parallelism over this rank's tokens and experts (module docstring).
    ``stats``, a dict, receives the call's ``dropped`` assignments (a
    device count), ``assigned`` and ``capacity``."""
    b, s, d = x.shape
    t = b * s
    if policy is None or policy.mesh is None:
        out, aux = _moe_local(x.reshape(t, d), params, cfg,
                              expert_capacity(cfg, t), stats)
    elif policy.model_axis_size > 1:
        out, aux = _moe_ep(x.reshape(t, d), params, cfg, policy, stats)
    else:
        raise ValueError(
            "moe_ffn under a mesh without a 'model' axis: the reference "
            "routes the global batch at its global capacity there (GSPMD); "
            "explicit SPMD holds local tokens, so give the mesh a 'model' "
            "axis for expert parallelism")
    return out.reshape(b, s, d), aux

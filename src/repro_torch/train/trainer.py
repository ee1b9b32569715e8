"""Training loop: the train-step factory, gradient accumulation,
checkpointing, failure recovery and the step-time watchdog (straggler
detection).

Twin of ``src/repro/train/trainer.py:23-138``. The step is model-agnostic:
it takes any ``loss_fn(params, batch)`` whose value depends on ``params``,
a flat ``dict[str, Tensor]`` of leaf tensors (a model's
``dict(model.named_parameters())``, so the loss closes over the model and
reads the same tensors). Gradients come from ``torch.autograd.grad``.

Where the reference's jitted step returns a new state and its train loop
donates the old one, the port's step updates in place: the parameters
under ``torch.no_grad()`` and the optimizer's buffers inside its
``update``. A ``TrainState`` passed to a step is therefore consumed, and
the one returned holds the same tensors. The state's ``step`` is an int32
0-d tensor on the parameters' device.

Checkpoints are written in the reference's layout
(``models/convert.py::train_state_to_numpy``), so either package resumes
the other's run.

Under a mesh (``policy=`` with a ``DeviceMesh``, explicit SPMD) every rank
holds its shard of each parameter, in the layout the policy carries for
it (``policy.with_params(transformer.param_rules(cfg, policy))``), and
runs the step on its own batch. Its backward gives each parameter the
rank's share of the gradient (PORT.md, "Model parallelism
(training)"), so the step does what GSPMD does for
the reference: it sums each gradient over the mesh axes its parameter is
replicated along and the ranks' work differs along (``batch_axes``: the
data axes, where each rank saw other sequences; "model" for the norms,
biases, qk-norm scales and the router, which each rank applied to its
own tokens or features; every axis for GAT's edge shards), in one
float32 ``psum`` a group of parameters sharing those axes. The optimizer
must be built with the same ``policy`` (its statistics span whole
leaves), or be ZeRO-1's (``optimizer.zero1``: parameters whole, the
state sharded), and ``train_loop`` saves whole leaves
(``models/convert.py``, ``train/checkpoint.py``).
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.models import convert
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib


class TrainState(NamedTuple):
    params: dict
    opt_state: Any
    step: torch.Tensor


def init_state(params: dict, optimizer: opt_lib.Optimizer) -> TrainState:
    device = opt_lib._device(params)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _value_and_grad(loss_fn: Callable, params: dict, batch):
    leaves = list(params.values())
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), grads)}


def _split(batch, grad_accum: int, i: int):
    """Micro-batch ``i`` of ``grad_accum``: each leaf's leading axis cut
    into ``grad_accum`` equal slices."""
    if batch is None:
        return None
    if isinstance(batch, dict):
        return {k: _split(v, grad_accum, i) for k, v in batch.items()}
    rows = batch.shape[0] // grad_accum
    if rows * grad_accum != batch.shape[0]:
        raise ValueError(f"a batch of {batch.shape[0]} does not split into "
                         f"{grad_accum} micro-batches")
    return batch[i * rows:(i + 1) * rows]


def batch_axes(policy) -> tuple[str, ...]:
    """The mesh axes along which the ranks' work differs: those the
    policy's ``act_btd`` rule tiles (the batch, and the sequence under
    sequence parallelism), or every axis of more than one rank for a
    policy without one (GAT's edge shards). Along any other axis the
    ranks hold the same rows and do the same work (a recsys model's dense
    part along "model"), so each already holds the whole gradient."""
    if "act_btd" in policy.rules:
        return policy.sharded_over("act_btd")
    return policy.replicated_over(())


def reduce_grads(grads: dict, policy=None) -> dict:
    """Each rank's gradient shares summed over the mesh axes their
    parameter is replicated along and the work differs along
    (``batch_axes``; module docstring): one flat ``psum`` a group of
    parameters with the same axes, in the dict's order. The
    sum runs in float32 and stays float32 (as Megatron's
    ``accumulate_allreduce_grads_in_fp32``): bf16 shares added in bf16
    would round the sum once more than one device's product rounds its
    gradient, and the optimizers take float32 anyway. The identity
    without a mesh."""
    if policy is None or policy.mesh is None:
        return grads
    from repro_torch.dist import collectives as coll
    groups: dict[tuple, list[str]] = {}
    differ = batch_axes(policy)
    for name in grads:
        axes = tuple(a for a in policy.replicated_over(
            policy.param_rule(name)) if a in differ)
        if axes:
            groups.setdefault(axes, []).append(name)
    out = dict(grads)
    for axes, names in groups.items():
        flat = coll.psum(torch.cat([grads[k].reshape(-1).to(torch.float32)
                                    for k in names]), policy, axes)
        for k, part in zip(names, flat.split([grads[k].numel()
                                              for k in names])):
            out[k] = part.view(grads[k].shape)
    return out


def make_train_step(loss_fn: Callable, optimizer: opt_lib.Optimizer,
                    *, grad_accum: int = 1, grad_barrier: bool = False,
                    policy=None):
    """Returns step(state, batch) -> (state, metrics).

    With grad_accum > 1 the batch's leading axis is split into
    ``grad_accum`` micro-batches run one after another; their gradients
    add up in float32 and are divided by ``grad_accum``, their losses
    likewise. ``metrics`` holds ``loss``, ``grad_norm`` (of the gradients
    before any clipping) and ``step``, as 0-d device tensors.

    grad_barrier: the reference's XLA scheduling knob (an optimization
    barrier between the backward and the optimizer, which orders a
    data-parallel all-reduce); eager PyTorch runs in order, so it does
    nothing.

    Under a mesh ``policy`` (carrying each parameter's layout rule) the
    batch is the rank's, micro-batches split its leading axis, and the
    accumulated gradients are reduced once (``reduce_grads``) before the
    optimizer and ``grad_norm``: ``loss_fn`` must return the global loss
    (``transformer.lm_loss(model, batch, policy)`` does).
    """
    del grad_barrier

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state.params
        if grad_accum == 1:
            loss, grads = _value_and_grad(loss_fn, params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in params.items()}
            for i in range(grad_accum):
                loss_i, g = _value_and_grad(loss_fn, params,
                                            _split(batch, grad_accum, i))
                for k in grads:
                    grads[k].add_(g[k])
                loss = loss + loss_i
                del g
            loss = loss / grad_accum
            grads = {k: g.div_(grad_accum) for k, g in grads.items()}
        with torch.no_grad():
            grads = reduce_grads(grads, policy)

        updates, opt_state = optimizer.update(grads, state.opt_state, params)
        opt_lib.apply_updates(params, updates)
        metrics = {"loss": loss,
                   "grad_norm": opt_lib.global_norm(grads, policy),
                   "step": state.step + 1}
        return TrainState(params, opt_state, state.step + 1), metrics

    return step


@dataclasses.dataclass
class Watchdog:
    """Step-time watchdog: flags stragglers (steps slower than
    ``threshold`` x the trailing median). Persistent flags are the signal
    for an elastic restart (the launcher's policy)."""

    threshold: float = 3.0
    window: int = 32
    _times: list = dataclasses.field(default_factory=list)
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        self._times.append(dt)
        self._times = self._times[-self.window:]
        if len(self._times) < 5:
            return False
        med = statistics.median(self._times[:-1])
        slow = dt > self.threshold * med
        if slow:
            self.slow_steps += 1
        return slow


def train_loop(state: TrainState, step_fn, data_iter, *, n_steps: int,
               ckpt_dir: str | None = None, ckpt_every: int = 100,
               log_every: int = 10, metadata: dict | None = None,
               fail_at_step: int | None = None,
               log_fn: Callable[[str], None] = print,
               policy=None) -> TrainState:
    """Run from ``state.step`` to ``n_steps`` with periodic checkpoints
    (the newest 3 kept) and the watchdog. Under a mesh ``policy`` every
    rank runs the loop on its own batches; a checkpoint gathers the whole
    leaves onto the mesh's first rank, which writes them
    (``convert.train_state_to_numpy``, ``checkpoint.save``).

    fail_at_step: raise a simulated failure once at the given step (the
    launcher's recovery path restarts from the latest checkpoint; see
    ``launch/train.py``).
    """
    watchdog = Watchdog()
    start = int(state.step)
    for i in range(start, n_steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        if fail_at_step is not None and i == fail_at_step:
            raise RuntimeError(f"simulated worker failure at step {i}")
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])          # waits for the step
        dt = time.perf_counter() - t0
        if watchdog.observe(dt):
            log_fn(f"[watchdog] step {i} took {dt:.3f}s "
                   f"(>{watchdog.threshold}x median) -- straggler suspect")
        if (i + 1) % log_every == 0:
            log_fn(f"step {i+1}: loss={loss:.4f} "
                   f"gnorm={float(metrics['grad_norm']):.3f} "
                   f"dt={dt*1e3:.1f}ms")
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            ckpt_lib.save(ckpt_dir, i + 1,
                          convert.train_state_to_numpy(state, policy),
                          metadata, policy=policy)
            ckpt_lib.prune(ckpt_dir, keep=3, policy=policy)
    return state

"""LM training driver with checkpoint/restart (twin of
``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm --model 100m --steps 200 [--device cpu]

--model 100m is a ~100M-parameter dense transformer (the task's end-to-end
training target); --model tiny runs in seconds for CI. Resumes
automatically from --ckpt-dir; --fail-at N simulates a worker crash to
exercise recovery (the run raises; run it again without the flag to
resume). The token stream is step-indexed: a resumed run skips the
batches its checkpoint's steps consumed, so it ends where an
uninterrupted run ends.
"""

from __future__ import annotations

import argparse
import itertools

import torch

from repro_torch.data import synthetic
from repro_torch.examples._common import add_flags
from repro_torch.models import convert
from repro_torch.models import transformer as tf_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import init_state, make_train_step, train_loop

MODELS = {
    "tiny": tf_lib.LMConfig(
        name="tiny", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
        d_head=32, d_ff=512, vocab=2048, dtype=torch.float32, attn_chunk=64),
    # ~100M params: 12L x 640d, vocab 32k
    "100m": tf_lib.LMConfig(
        name="100m", n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
        d_head=64, d_ff=2560, vocab=32768, dtype=torch.float32,
        attn_chunk=128),
}


def optimizer(steps: int) -> opt_lib.Optimizer:
    """The example's optimizer: clip at 1.0, then AdamW on a cosine
    schedule peaking at 3e-4 after 20 warmup steps."""
    return opt_lib.chain(opt_lib.clip_by_global_norm(1.0),
                         opt_lib.adamw(opt_lib.cosine_schedule(
                             3e-4, warmup=20, total=steps)))


def run(cfg: tf_lib.LMConfig, *, steps: int, batch: int, seq: int,
        ckpt_dir: str | None = None, ckpt_every: int = 25,
        fail_at: int | None = None, grad_accum: int = 1, seed: int = 0,
        device="cuda") -> dict:
    """Train ``cfg`` (weights from a generator on ``device`` seeded
    ``seed``, tokens from one seeded ``seed + 1``) to ``steps``, resuming
    from the newest checkpoint in ``ckpt_dir``; ``fail_at`` raises the
    simulated failure at that step. Returns the model, the final state,
    each step's loss and the step it resumed from (None for a fresh
    run)."""
    print(f"model={cfg.name} params~{cfg.n_params/1e6:.1f}M")
    model = tf_lib.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)
    opt = optimizer(steps)
    step = make_train_step(lambda p, b: tf_lib.lm_loss(model, b), opt,
                           grad_accum=grad_accum)
    losses = []

    def recorded(state, b):
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        return state, metrics

    state = init_state(dict(model.named_parameters()), opt)

    # resume if a checkpoint exists (deterministic, step-indexed data)
    last = None
    if ckpt_dir:
        last = ckpt_lib.latest_step(ckpt_dir)
        if last is not None:
            tree, _ = ckpt_lib.restore(ckpt_dir, last,
                                       convert.train_state_to_numpy(state))
            state = convert.train_state_from_jax(tree, state)
            print(f"resumed from step {last}")

    data = synthetic.lm_token_batches(
        torch.Generator(device=device).manual_seed(seed + 1), batch, seq,
        cfg.vocab)
    data = itertools.islice(data, int(state.step), None)
    state = train_loop(state, recorded, data, n_steps=steps,
                       ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                       log_every=10, fail_at_step=fail_at,
                       metadata={"model": cfg.name})
    print(f"done at step {int(state.step)}")
    return {"model": model, "state": state, "losses": losses,
            "resumed_from": last}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=MODELS, default="tiny")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--grad-accum", type=int, default=1)
    add_flags(ap)
    args = ap.parse_args(argv)

    return run(MODELS[args.model], steps=args.steps, batch=args.batch,
               seq=args.seq, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, fail_at=args.fail_at,
               grad_accum=args.grad_accum, seed=args.seed,
               device=args.device)


if __name__ == "__main__":
    main()

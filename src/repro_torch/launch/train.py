"""Train launcher: --arch <id> --smoke with checkpoint-based failure
recovery and restart.

Twin of ``src/repro/launch/train.py:33-168``: the same flags, the same
restart loop and the same log lines (``worker failure``, ``restored step
N``, ``training complete at step N``). ``--smoke`` runs the reduced config
of the arch (an LM, the GNN or a recsys model) through the trainer,
checkpointing, the watchdog and the recovery loop; without it the
launcher exits 2, as the reference does (full-scale training needs the
production mesh). It runs on the card unless ``--device cpu`` is given.
Draws come from ``torch.Generator``s seeded 0 (the graph from numpy's
``default_rng(0)``, as in the reference).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --smoke --steps 30 --ckpt-dir /tmp/ck --simulate-failure 12
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import base as cfg_base
from repro_torch.data import graph as graph_data
from repro_torch.data import synthetic
from repro_torch.models import convert
from repro_torch.models import gat as gat_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import TrainState, make_train_step, train_loop


def _ids(gen, vocab_sizes, rows: int, dev) -> torch.Tensor:
    """(rows, fields) ids, each field uniform over its vocabulary."""
    return torch.stack([torch.randint(0, v, (rows,), generator=gen,
                                      device=dev) for v in vocab_sizes], -1)


def _bernoulli(gen, p: float, rows: int, dev) -> torch.Tensor:
    return (torch.rand(rows, generator=gen, device=dev) < p).to(
        torch.float32)


def _smoke_setup(arch, dev):
    """(model, data iterator, loss_fn(params, batch)) of the arch's smoke
    config on ``dev``."""
    cfg = arch.make_smoke_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    if arch.family == "lm":
        model = tf_lib.init_params(cfg, gen, dev)
        data = synthetic.lm_token_batches(
            torch.Generator(device=dev).manual_seed(1), 4, 64, cfg.vocab)
        return model, data, lambda p, b: tf_lib.lm_loss(model, b)
    if arch.family == "gnn":
        rng = np.random.default_rng(0)
        g = graph_data.random_power_law_graph(rng, 256, 8, cfg.d_in,
                                              cfg.n_classes)

        def gnn_batches():
            while True:
                seeds = rng.choice(256, 16, replace=False)
                sub = graph_data.sample_subgraph(rng, g, seeds, (5, 3),
                                                 pad_nodes=256,
                                                 pad_edges=1024)
                yield {k: torch.as_tensor(v, device=dev)
                       for k, v in sub.items()}

        model = gat_lib.init_params(cfg, gen, dev)
        return (model, gnn_batches(),
                lambda p, b: gat_lib.loss_fn(model, b, cfg))
    if arch.arch_id in ("deepfm", "xdeepfm"):
        model = rec_lib.init_ctr_params(gen, cfg, device=dev)

        def ctr_batches():
            while True:
                yield {"sparse": _ids(gen, cfg.embedding.vocab_sizes, 64,
                                      dev),
                       "label": _bernoulli(gen, 0.3, 64, dev)}
        return (model, ctr_batches(),
                lambda p, b: rec_lib.ctr_loss(model, b, cfg))
    if arch.arch_id == "din":
        model = rec_lib.init_din_params(gen, cfg, device=dev)
        vs = cfg.embedding.vocab_sizes

        def din_batches():
            while True:
                yield {"hist": _ids(gen, (vs[0],) * cfg.seq_len, 32, dev),
                       "hist_mask": torch.ones((32, cfg.seq_len), dtype=bool,
                                               device=dev),
                       "target": _ids(gen, vs[:1], 32, dev)[:, 0],
                       "profile": _ids(gen, vs[1:], 32, dev),
                       "label": _bernoulli(gen, 0.5, 32, dev)}
        return (model, din_batches(),
                lambda p, b: rec_lib.din_loss(model, b, cfg))
    model = rec_lib.init_twotower_params(gen, cfg, device=dev)

    def twotower_batches():
        while True:
            yield {"user_feats": _ids(gen, cfg.user_embedding.vocab_sizes,
                                      64, dev),
                   "item_feats": _ids(gen, cfg.item_embedding.vocab_sizes,
                                      64, dev),
                   "log_q": torch.zeros(64, device=dev)}
    return (model, twotower_batches(),
            lambda p, b: rec_lib.twotower_loss(model, b, cfg))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--simulate-failure", type=int, default=None,
                    help="raise a simulated worker failure at this step; "
                         "the launcher recovers from the last checkpoint")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    arch = cfg_base.get(args.arch)
    if not args.smoke:
        print("full-scale training requires the production mesh; this "
              "launcher runs --smoke (same control path, reduced config)")
        return 2

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("[launcher] no CUDA device; pass --device cpu",
              file=sys.stderr)
        return 1
    model, data, loss = _smoke_setup(arch, dev)
    params = dict(model.named_parameters())
    opt = opt_lib.chain(opt_lib.clip_by_global_norm(1.0),
                        opt_lib.adamw(1e-3))
    step = make_train_step(loss, opt)
    state = TrainState(params, opt.init(params),
                       torch.zeros((), dtype=torch.int32, device=dev))

    fail_at = args.simulate_failure
    restarts = 0
    while True:
        if args.ckpt_dir:
            last = ckpt_lib.latest_step(args.ckpt_dir)
            if last is not None:
                tree, _ = ckpt_lib.restore(
                    args.ckpt_dir, last, convert.train_state_to_numpy(state))
                state = convert.train_state_from_jax(tree, state)
                print(f"[launcher] restored step {last}")
        try:
            state = train_loop(state, step, data, n_steps=args.steps,
                               ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every,
                               fail_at_step=fail_at, log_every=10)
            break
        except RuntimeError as e:
            restarts += 1
            print(f"[launcher] worker failure: {e}; restart {restarts}")
            if restarts > args.max_restarts:
                print("[launcher] restart budget exhausted")
                return 1
            fail_at = None          # failure cleared on restart
    print(f"[launcher] training complete at step {int(state.step)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

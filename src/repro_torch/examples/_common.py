"""What the example twins share: the flags each adds to its reference's,
a check that raises under ``python -O`` too, a device sync for wall
clocks, and the two-tower examples' batches and embeddings."""

from __future__ import annotations

import argparse

import torch


def add_flags(ap: argparse.ArgumentParser) -> None:
    """``--device`` and ``--seed``, beside the reference example's flags."""
    ap.add_argument("--device", default="cuda",
                    help="where the example runs (cuda, or cpu for the "
                         "plain PyTorch versions of the kernels)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the torch generators the data and the "
                         "build's draws come from")


def check(ok, msg: str) -> None:
    """The reference example's ``assert``, kept under ``python -O``."""
    if not ok:
        raise AssertionError(msg)


def sync(device) -> None:
    """Wait for the device's queued work (the reference's
    ``block_until_ready``)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def feature_ids(generator: torch.Generator, vocab_sizes, rows: int
                ) -> torch.Tensor:
    """(rows, fields) int32 feature ids, each field uniform over its
    vocabulary, drawn on the generator's device."""
    return torch.stack([torch.randint(0, v, (rows,), generator=generator,
                                      device=generator.device,
                                      dtype=torch.int32)
                        for v in vocab_sizes], -1)


def two_tower_batch(cfg, generator: torch.Generator, rows: int) -> dict:
    """One in-batch softmax batch of uniform user and item features, with
    no logQ correction (the reference examples' synthetic interactions)."""
    return {"user_feats": feature_ids(generator,
                                      cfg.user_embedding.vocab_sizes, rows),
            "item_feats": feature_ids(generator,
                                      cfg.item_embedding.vocab_sizes, rows),
            "log_q": torch.zeros(rows, device=generator.device)}


def train_two_tower(model, cfg, batches, optimizer) -> list[float]:
    """One ``make_train_step`` step of ``twotower_loss`` a batch; returns
    the losses. The model's parameters are updated in place."""
    from repro_torch.models import recsys
    from repro_torch.train.trainer import init_state, make_train_step
    params = dict(model.named_parameters())
    step = make_train_step(lambda p, b: recsys.twotower_loss(model, b, cfg),
                           optimizer)
    state = init_state(params, optimizer)
    losses = []
    for batch in batches:
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses

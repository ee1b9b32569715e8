"""Architecture registry of the port: each arch the port runs is a
selectable config carrying its full config, a reduced smoke config and its
shape cells.

Twin of ``src/repro/configs/base.py``, copied so that the port imports
nothing of the reference package. ``_ensure_loaded`` registers every arch
of the reference: the dense LMs qwen3-0.6b, qwen2-1.5b (its ``qkv_bias``
takes the same code path) and mistral-nemo-12b, the MoE LMs olmoe-1b-7b
and dbrx-132b (``models/moe.py``), the four recsys archs (deepfm,
xdeepfm, din, two-tower-retrieval; ``models/recsys.py``) and the GNN
gat-cora (``models/gat.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode | serve | retrieval
    dims: dict         # shape parameters (family-specific)
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str        # lm | gnn | recsys
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: tuple[ShapeSpec, ...]
    tp_heads: bool = True      # lm: attention-head TP divisible by 16
    pure_dp_train: bool = False  # lm: small models train pure-DP (single pod)
    train_grad_accum: int = 1  # lm: microbatching for activation memory
    source: str = ""
    notes: str = ""

    def shape(self, name: str) -> ShapeSpec:
        for s in self.shapes:
            if s.name == name:
                return s
        raise KeyError(f"{self.arch_id} has no shape {name!r}")


_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    _REGISTRY[spec.arch_id] = spec
    return spec


def get(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    return _REGISTRY[arch_id]


def all_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # Import side effects register every arch the port has.
    from repro_torch.configs import (  # noqa: F401
        dbrx_132b, deepfm, din, gat_cora, mistral_nemo_12b, olmoe_1b_7b,
        qwen2_1_5b, qwen3_0_6b, two_tower_retrieval, xdeepfm)


LM_SHAPES = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill",
              {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode",
              {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "decode",
              {"seq_len": 524288, "global_batch": 1},
              note="decode against a 500k KV cache is linear per step; run "
                   "with the cache sequence-sharded over the whole mesh "
                   "(DESIGN.md SS4). A 500k *prefill* would be quadratic and "
                   "is out of scope for these full-attention archs."),
)

RECSYS_SHAPES = (
    ShapeSpec("train_batch", "train", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval",
              {"batch": 1, "n_candidates": 1_000_000}),
)

"""olmoe-1b-7b: 16L d_model=2048 16H (GQA kv=16) MoE 64 experts top-8,
d_ff_expert=1024, vocab=50304. [arXiv:2409.02060; hf]

Twin of ``src/repro/configs/olmoe_1b_7b.py``."""

import torch

from repro_torch.configs import base
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_head=128, d_ff=1024, vocab=50304,
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
        qk_norm=True, rope_theta=10000.0, dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="olmoe-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_head=32, d_ff=128, vocab=512, qk_norm=True,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=128),
        dtype=torch.float32, max_seq=64, attn_chunk=32)


base.register(base.ArchSpec(
    arch_id="olmoe-1b-7b", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=base.LM_SHAPES,
    tp_heads=True, source="arXiv:2409.02060",
    notes="64 experts top-8; EP over 'model' (4 experts/chip)"))

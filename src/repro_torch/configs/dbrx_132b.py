"""dbrx-132b: 40L d_model=6144 48H (GQA kv=8) MoE 16 experts top-4,
d_ff_expert=10752, vocab=100352. [hf:databricks/dbrx-base; unverified]

Twin of ``src/repro/configs/dbrx_132b.py``. At ~263 GB in bf16 the full
config does not fit one H100; the port runs its smoke config."""

import torch

from repro_torch.configs import base
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, d_head=128, d_ff=10752, vocab=100352,
        moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752),
        rope_theta=500000.0, dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="dbrx-132b-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_head=16, d_ff=224, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=224),
        dtype=torch.float32, max_seq=64, attn_chunk=32)


base.register(base.ArchSpec(
    arch_id="dbrx-132b", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=base.LM_SHAPES,
    tp_heads=True, train_grad_accum=4, source="hf:databricks/dbrx-base",
    notes="fine-grained MoE 16e top-4; EP over 'model' (1 expert/chip); "
          "grad-accum 2 halves activation residency at 132B scale"))

"""qwen3-0.6b: 28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936,
qk_norm. [hf:Qwen/Qwen3-0.6B family; hf]

Twin of ``src/repro/configs/qwen3_0_6b.py``."""

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16,
        n_kv_heads=8, d_head=128, d_ff=3072, vocab=151936, qk_norm=True,
        rope_theta=1000000.0, dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen3-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_head=32, d_ff=256, vocab=512, qk_norm=True,
        dtype=torch.float32, max_seq=64, attn_chunk=32)


base.register(base.ArchSpec(
    arch_id="qwen3-0.6b", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=base.LM_SHAPES,
    tp_heads=True, pure_dp_train=False, source="hf:Qwen/Qwen3-8B",
    notes="small dense: trains pure-DP on the single-pod mesh (DESIGN SS5)"))

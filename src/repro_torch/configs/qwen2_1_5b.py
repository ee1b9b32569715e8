"""qwen2-1.5b: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936,
QKV bias. [arXiv:2407.10671; hf]

Twin of ``src/repro/configs/qwen2_1_5b.py``."""

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="qwen2-1.5b", n_layers=28, d_model=1536, n_heads=12,
        n_kv_heads=2, d_head=128, d_ff=8960, vocab=151936, qkv_bias=True,
        rope_theta=1000000.0, dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="qwen2-smoke", n_layers=2, d_model=96, n_heads=6,
        n_kv_heads=2, d_head=16, d_ff=256, vocab=512, qkv_bias=True,
        dtype=torch.float32, max_seq=64, attn_chunk=32)


base.register(base.ArchSpec(
    arch_id="qwen2-1.5b", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=base.LM_SHAPES,
    tp_heads=False,  # 12 heads % 16 != 0: no head TP (weights still shard)
    pure_dp_train=False, source="arXiv:2407.10671",
    notes="12 heads not divisible by model=16: attention-head activations "
          "stay unsharded on 'model'; FFN/vocab TP still applies"))

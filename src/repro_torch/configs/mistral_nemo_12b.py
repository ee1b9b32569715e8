"""mistral-nemo-12b: 40L d_model=5120 32H (GQA kv=8) d_head=128 d_ff=14336
vocab=131072, 128k ctx. [hf:mistralai/Mistral-Nemo-Base-2407; hf]

Twin of ``src/repro/configs/mistral_nemo_12b.py``. Its d_model (5,120) is
not n_heads * d_head (4,096): wq is (5120, 4096) and wo (4096, 5120)."""

import torch

from repro_torch.configs import base
from repro_torch.models.transformer import LMConfig


def make_config() -> LMConfig:
    return LMConfig(
        name="mistral-nemo-12b", n_layers=40, d_model=5120, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=14336, vocab=131072,
        rope_theta=1000000.0, dtype=torch.bfloat16)


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="nemo-smoke", n_layers=2, d_model=128, n_heads=8,
        n_kv_heads=2, d_head=16, d_ff=352, vocab=512,
        dtype=torch.float32, max_seq=64, attn_chunk=32)


base.register(base.ArchSpec(
    arch_id="mistral-nemo-12b", family="lm", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=base.LM_SHAPES,
    tp_heads=True, train_grad_accum=2,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
    notes="dense 12B; TP+FSDP; long_500k extrapolates its 128k ctx "
          "(structurally identical decode)"))

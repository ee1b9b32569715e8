"""xdeepfm: 39 sparse fields, embed_dim=10, CIN 200-200-200, MLP 400-400.
[arXiv:1803.05170]

Twin of ``src/repro/configs/xdeepfm.py``."""

from repro_torch.configs import base
from repro_torch.configs.deepfm import VOCABS
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys import CTRConfig


def make_config() -> CTRConfig:
    return CTRConfig(
        name="xdeepfm",
        embedding=EmbeddingConfig(vocab_sizes=VOCABS, dim=10),
        mlp_dims=(400, 400), interaction="cin",
        cin_layers=(200, 200, 200))


def make_smoke_config() -> CTRConfig:
    return CTRConfig(
        name="xdeepfm-smoke",
        embedding=EmbeddingConfig(vocab_sizes=(1000, 500, 200, 100), dim=8),
        mlp_dims=(32, 32), interaction="cin", cin_layers=(8, 8))


base.register(base.ArchSpec(
    arch_id="xdeepfm", family="recsys", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=base.RECSYS_SHAPES,
    source="arXiv:1803.05170",
    notes="CIN = explicit high-order feature interactions (einsum), the "
          "compute-dominant branch at large batch"))

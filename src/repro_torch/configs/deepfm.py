"""deepfm: 39 sparse fields, embed_dim=10, MLP 400-400-400, FM interaction.
[arXiv:1703.04247]

Vocab layout (Criteo-like power law, ~37M total rows): 3 x 10M + 6 x 1M +
10 x 100k + 20 x 10k. Tables are padded to a 'model'-axis multiple for
mod-row sharding.

Twin of ``src/repro/configs/deepfm.py``.
"""

from repro_torch.configs import base
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys import CTRConfig

VOCABS = (10_000_000,) * 3 + (1_000_000,) * 6 + (100_000,) * 10 + \
    (10_000,) * 20


def make_config() -> CTRConfig:
    return CTRConfig(
        name="deepfm",
        embedding=EmbeddingConfig(vocab_sizes=VOCABS, dim=10),
        mlp_dims=(400, 400, 400), interaction="fm")


def make_smoke_config() -> CTRConfig:
    return CTRConfig(
        name="deepfm-smoke",
        embedding=EmbeddingConfig(vocab_sizes=(1000, 500, 200, 100), dim=8),
        mlp_dims=(32, 32), interaction="fm")


base.register(base.ArchSpec(
    arch_id="deepfm", family="recsys", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=base.RECSYS_SHAPES,
    source="arXiv:1703.04247",
    notes="SAH used upstream (candidate generation), not inside the ranker"))

"""din: embed_dim=18, behaviour seq_len=100, attention MLP 80-40,
main MLP 200-80, target attention. [arXiv:1706.06978]

Field 0 is the 20M-item vocabulary (history + target share it); two profile
fields (100k, 10k).

Twin of ``src/repro/configs/din.py``.
"""

from repro_torch.configs import base
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys import DINConfig


def make_config() -> DINConfig:
    return DINConfig(
        name="din",
        embedding=EmbeddingConfig(
            vocab_sizes=(20_000_000, 100_000, 10_000), dim=18),
        seq_len=100, attn_mlp=(80, 40), mlp_dims=(200, 80))


def make_smoke_config() -> DINConfig:
    return DINConfig(
        name="din-smoke",
        embedding=EmbeddingConfig(vocab_sizes=(2000, 100, 50), dim=8),
        seq_len=16, attn_mlp=(16, 8), mlp_dims=(32, 16))


base.register(base.ArchSpec(
    arch_id="din", family="recsys", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=base.RECSYS_SHAPES,
    source="arXiv:1706.06978",
    notes="retrieval_cand re-runs target attention per candidate (inherent "
          "to DIN scoring)"))

"""two-tower-retrieval: embed_dim=256 output, towers 1024-512-256, dot
interaction, sampled-softmax training. [Yi et al. RecSys'19]

This is the paper's home architecture: `retrieval_cand` (1 query x 1M
candidates) is MIPS -- served either exact (fused ip_topk kernel) or through
the SAH/SA-ALSH sketch index; the reverse direction is RkMIPS itself.

Twin of ``src/repro/configs/two_tower_retrieval.py``.
"""

from repro_torch.configs import base
from repro_torch.models.embedding import EmbeddingConfig
from repro_torch.models.recsys import TwoTowerConfig


def make_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        name="two-tower-retrieval",
        user_embedding=EmbeddingConfig(
            vocab_sizes=(10_000_000, 100_000, 10_000), dim=64),
        item_embedding=EmbeddingConfig(
            vocab_sizes=(10_000_000, 100_000), dim=64),
        tower_dims=(1024, 512), out_dim=256)


def make_smoke_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        name="two-tower-smoke",
        user_embedding=EmbeddingConfig(vocab_sizes=(5000, 100), dim=16),
        item_embedding=EmbeddingConfig(vocab_sizes=(2000, 50), dim=16),
        tower_dims=(64, 32), out_dim=32)


base.register(base.ArchSpec(
    arch_id="two-tower-retrieval", family="recsys", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=base.RECSYS_SHAPES,
    source="RecSys'19 (YouTube)",
    notes="paper-technique cell: retrieval_cand has exact + SAH serve modes"))

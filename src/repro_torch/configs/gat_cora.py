"""gat-cora: 2L d_hidden=8 8 heads attention aggregator. [arXiv:1710.10903]

Shapes span the three GNN regimes: full-batch small (Cora), neighbor-sampled
training (Reddit-scale fanout 15-10), full-batch large (ogbn-products), and
batched small graphs (molecule). Edge counts are padded to 8192-multiples for
even sharding over the 256/512-way mesh.

Twin of ``src/repro/configs/gat_cora.py``.
"""

from repro_torch.configs import base
from repro_torch.models.gat import GATConfig


def _pad(x: int, mult: int = 8192) -> int:
    return -(-x // mult) * mult


SHAPES = (
    base.ShapeSpec("full_graph_sm", "train",
                   {"n_nodes": 2708, "n_edges": _pad(10556), "d_feat": 1433,
                    "n_classes": 7}),
    base.ShapeSpec("minibatch_lg", "train",
                   {"n_nodes": 169984, "n_edges": _pad(168960), "d_feat": 602,
                    "n_classes": 41, "batch_nodes": 1024,
                    "fanout": (15, 10)},
                   note="padded 2-hop sampled subgraph: 1024 seeds x "
                        "(1 + 15 + 150) nodes; host CSR sampler feeds it"),
    base.ShapeSpec("ogb_products", "train",
                   {"n_nodes": 2449029, "n_edges": _pad(61859140),
                    "d_feat": 100, "n_classes": 47}),
    base.ShapeSpec("molecule", "train",
                   {"n_nodes": 30 * 128, "n_edges": _pad(64 * 128, 1024),
                    "d_feat": 32, "n_classes": 2, "n_graphs": 128},
                   note="block-diagonal batch of 128 30-node graphs; "
                        "graph-level classification via segment mean-pool"),
)


def make_config() -> GATConfig:
    return GATConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
                     d_in=1433, n_classes=7)


def make_smoke_config() -> GATConfig:
    return GATConfig(name="gat-smoke", n_layers=2, d_hidden=4, n_heads=2,
                     d_in=16, n_classes=3)


base.register(base.ArchSpec(
    arch_id="gat-cora", family="gnn", make_config=make_config,
    make_smoke_config=make_smoke_config, shapes=SHAPES,
    source="arXiv:1710.10903",
    notes="SAH inapplicable (no inner-product search in message passing); "
          "d_in/n_classes are overridden per shape"))

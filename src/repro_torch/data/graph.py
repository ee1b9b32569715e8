"""Graph generation + host-side CSR neighbour sampler (GraphSAGE-style).

Twin of ``src/repro/data/graph.py``, copied (numpy only) so the port
imports nothing of the reference: the same ``np.random.default_rng(seed)``
gives the same arrays in both packages. Graphs are host-side numpy; the
GAT (``models/gat.py``) takes the padded edge lists as tensors.

The `minibatch_lg` shape requires a real neighbor sampler: CSR adjacency on
host (numpy), fanout-limited multi-hop sampling producing fixed-size padded
subgraph batches for the device step.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray      # (N+1,)
    indices: np.ndarray     # (E,)
    features: np.ndarray    # (N, d)
    labels: np.ndarray      # (N,)

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def random_power_law_graph(rng: np.random.Generator, n_nodes: int,
                           avg_degree: int, d_feat: int,
                           n_classes: int) -> CSRGraph:
    """Preferential-attachment-ish edge list -> CSR."""
    m = n_nodes * avg_degree
    # power-law targets: prob ~ rank^-0.8
    ranks = np.arange(1, n_nodes + 1, dtype=np.float64)
    p = ranks ** -0.8
    p /= p.sum()
    dst = rng.choice(n_nodes, size=m, p=p)
    src = rng.integers(0, n_nodes, size=m)
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.add.at(indptr, dst_s + 1, 1)
    indptr = np.cumsum(indptr)
    return CSRGraph(indptr=indptr, indices=src_s,
                    features=rng.standard_normal((n_nodes, d_feat),
                                                 dtype=np.float32),
                    labels=rng.integers(0, n_classes, n_nodes))


def sample_subgraph(rng: np.random.Generator, g: CSRGraph, seeds: np.ndarray,
                    fanout: tuple[int, ...], pad_nodes: int, pad_edges: int):
    """Fanout-limited k-hop sampled subgraph, padded to static shapes.

    Returns a dict matching models.gat.forward's graph layout with
    seed labels masked in. Node ids are remapped to [0, pad_nodes).
    """
    nodes = list(seeds)
    node_pos = {int(v): i for i, v in enumerate(seeds)}
    src_l, dst_l = [], []
    frontier = list(seeds)
    for f in fanout:
        nxt = []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            neigh = g.indices[lo:hi]
            if neigh.size > f:
                neigh = rng.choice(neigh, size=f, replace=False)
            for u in neigh:
                u = int(u)
                if u not in node_pos:
                    if len(nodes) >= pad_nodes:
                        continue
                    node_pos[u] = len(nodes)
                    nodes.append(u)
                    nxt.append(u)
                src_l.append(node_pos[u])
                dst_l.append(node_pos[v])
        frontier = nxt
    n, e = len(nodes), len(src_l)
    nodes_arr = np.asarray(nodes, np.int64)
    x = np.zeros((pad_nodes, g.features.shape[1]), np.float32)
    x[:n] = g.features[nodes_arr]
    src = np.zeros(pad_edges, np.int32)
    dst = np.zeros(pad_edges, np.int32)
    src[:e] = src_l
    dst[:e] = dst_l
    labels = np.zeros(pad_nodes, np.int32)
    labels[:n] = g.labels[nodes_arr]
    label_mask = np.zeros(pad_nodes, bool)
    label_mask[:len(seeds)] = True          # supervise seeds only
    emask = np.zeros(pad_edges, bool)
    emask[:e] = True
    return {"x": x, "src": src, "dst": dst, "edge_mask": emask,
            "labels": labels, "label_mask": label_mask}


def molecule_batch(rng: np.random.Generator, n_graphs: int, nodes_per: int,
                   edges_per: int, d_feat: int, n_classes: int,
                   pad_edges: int):
    """Block-diagonal batch of small graphs for graph-level classification."""
    n = n_graphs * nodes_per
    x = rng.standard_normal((n, d_feat), dtype=np.float32)
    src_l, dst_l = [], []
    for gi in range(n_graphs):
        off = gi * nodes_per
        s = rng.integers(0, nodes_per, edges_per) + off
        t = rng.integers(0, nodes_per, edges_per) + off
        src_l.append(s)
        dst_l.append(t)
    src = np.concatenate(src_l).astype(np.int32)
    dst = np.concatenate(dst_l).astype(np.int32)
    e = src.shape[0]
    src_p = np.zeros(pad_edges, np.int32)
    dst_p = np.zeros(pad_edges, np.int32)
    emask = np.zeros(pad_edges, bool)
    src_p[:e], dst_p[:e], emask[:e] = src, dst, True
    graph_id = np.repeat(np.arange(n_graphs, dtype=np.int32), nodes_per)
    return {"x": x, "src": src_p, "dst": dst_p, "edge_mask": emask,
            "graph_id": graph_id,
            "graph_labels": rng.integers(0, n_classes,
                                         n_graphs).astype(np.int32)}

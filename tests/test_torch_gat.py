"""The GAT and its graph data in the PyTorch port (``repro_torch.models.
gat``, ``repro_torch.data.graph``, ``configs/gat_cora.py``) held against
the JAX reference on the CPU.

The graph arrays come from the same ``np.random.default_rng(seed)`` in
both packages and must be equal exactly (integers and float32 draws
alike). Weights are the reference's ``init_params`` arrays copied into the
port bitwise. Tolerances, with reasons: the forward and the loss in
float32 within rtol 1e-5, atol 1e-6 (XLA and PyTorch sum each node's
messages in different orders; measured ~1e-7); gradients within 1e-5 of
each leaf's largest |value| plus 1e-6 of the largest gradient anywhere.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import base as jbase
from repro.data import graph as jgraph
from repro.models import gat as jgat

from repro_torch.configs import base
from repro_torch.data import graph
from repro_torch.models import convert, gat
from repro_torch.train.trainer import TrainState


def _graph_pairs(seed):
    """The same graph batches drawn by both packages: a sampled subgraph
    (node-level labels) and a molecule batch (graph-level)."""
    out = []
    for mod in (jgraph, graph):
        rng = np.random.default_rng(seed)
        g = mod.random_power_law_graph(rng, 64, 4, 16, 3)
        sub = mod.sample_subgraph(rng, g, rng.choice(64, 8, replace=False),
                                  (4, 2), pad_nodes=64, pad_edges=256)
        mol = mod.molecule_batch(rng, 4, 6, 9, 16, 3, pad_edges=64)
        out.append((g, sub, mol))
    return out


def test_graph_arrays_equal_reference_from_the_same_rng():
    (jg, jsub, jmol), (g, sub, mol) = _graph_pairs(0)
    for field in ("indptr", "indices", "features", "labels"):
        a, b = getattr(jg, field), getattr(g, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert g.n_nodes == jg.n_nodes == 64
    for want, got in ((jsub, sub), (jmol, mol)):
        assert sorted(want) == sorted(got)
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gat_config_and_registry_are_the_references():
    spec, jspec = base.get("gat-cora"), jbase.get("gat-cora")
    assert spec.family == jspec.family == "gnn"
    assert ([dataclasses.astuple(x) for x in spec.shapes]
            == [dataclasses.astuple(x) for x in jspec.shapes])
    assert spec.source == jspec.source
    for make in ("make_config", "make_smoke_config"):
        cfg, jcfg = getattr(spec, make)(), getattr(jspec, make)()
        for f in dataclasses.fields(jcfg):
            if f.name != "dtype":
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.dtype == torch.float32


@pytest.fixture(scope="module")
def pair():
    jcfg = jbase.get("gat-cora").make_smoke_config()
    cfg = base.get("gat-cora").make_smoke_config()
    jparams = jgat.init_params(jax.random.PRNGKey(0), jcfg)
    model = convert.gat_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        cfg, device="cpu")
    return jcfg, cfg, jparams, model


def test_params_from_jax_are_bitwise(pair):
    _, _, jparams, model = pair
    for i, layer in enumerate(jparams["layers"]):
        for name, leaf in layer.items():
            got = getattr(model.layers[i], name).detach().numpy()
            np.testing.assert_array_equal(got, np.asarray(leaf))


def test_port_init_matches_the_references_shapes_and_scales():
    cfg = base.get("gat-cora").make_config()
    model = gat.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    jshapes = jax.eval_shape(lambda: jgat.init_params(
        jax.random.PRNGKey(0), jbase.get("gat-cora").make_config()))
    for i, layer in enumerate(jshapes["layers"]):
        for name, leaf in layer.items():
            p = getattr(model.layers[i], name)
            assert tuple(p.shape) == leaf.shape, (i, name)
            scale = p.shape[0] ** -0.5 if name == "w" else \
                p.shape[-1] ** -0.5
            if p.numel() >= 1000:       # enough draws for a 5% check
                assert abs(float(p.detach().std()) / scale - 1) < 0.05, \
                    (i, name)


def _with_edge_cases(sub):
    """A subgraph with a padded tail (masked edges at node 0), a node
    with no incoming edge at all, and duplicated edges (ties in a node's
    max)."""
    sub = {k: v.copy() for k, v in sub.items()}
    n_real = int(sub["edge_mask"].sum())
    lonely = int(sub["dst"].max()) + 1
    sub["dst"][:n_real][sub["dst"][:n_real] == lonely] = 0
    sub["src"][n_real:n_real + 3] = sub["src"][:3]
    sub["dst"][n_real:n_real + 3] = sub["dst"][:3]
    sub["edge_mask"][n_real:n_real + 3] = True
    assert not (sub["dst"][sub["edge_mask"]] == lonely).any()
    assert not sub["edge_mask"].all()
    return sub


@pytest.mark.parametrize("kind", ["node", "graph"])
def test_forward_loss_and_grads_match_reference(pair, kind):
    jcfg, cfg, jparams, model = pair
    _, (_, sub, mol) = _graph_pairs(1)
    batch = _with_edge_cases(sub) if kind == "node" else mol
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        gat.forward(model, tb, cfg).detach().numpy(),
        np.asarray(jgat.forward(jparams, jb, jcfg)), rtol=1e-5, atol=1e-6)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jgat.loss_fn(p, jb, jcfg)))(jparams)
    params = dict(model.named_parameters())
    loss = gat.loss_fn(model, tb, cfg)
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    got = convert.train_state_to_numpy(
        TrainState(grads, (), torch.zeros((), dtype=torch.int32))).params
    want = jax.tree.map(np.asarray, jg)
    top = max(float(np.abs(w).max()) for w in jax.tree.leaves(want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        assert float(np.abs(g - w).max()) <= (
            1e-5 * float(np.abs(w).max()) + 1e-6 * top)


def test_a_node_without_incoming_edges_aggregates_zero(pair):
    """Its max stays -inf and nothing reads it: 0 / max(0, 1e-9) = 0
    before the ELU, as in the reference."""
    jcfg, cfg, jparams, model = pair
    x = np.random.default_rng(2).standard_normal((5, 16)).astype(np.float32)
    src = np.array([1, 2, 3, 0], np.int32)
    dst = np.array([2, 3, 1, 0], np.int32)     # node 4: no edge in
    emask = np.array([True, True, True, False])
    p = model.layers[0]
    got = gat.gat_layer(torch.from_numpy(x), torch.from_numpy(src).long(),
                        torch.from_numpy(dst).long(),
                        torch.from_numpy(emask), p, cfg, last=False)
    want = jgat.gat_layer(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
                          jnp.asarray(emask), jparams["layers"][0], jcfg,
                          last=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got[4], torch.zeros_like(got[4]))
    assert torch.equal(got[0], torch.zeros_like(got[0]))   # only a pad edge


def test_a_mesh_policy_is_refused(pair):
    """GAT under a policy: one without a mesh (``NO_SHARDING``) is the
    single-device layer bit for bit, in both aggregation modes; a policy
    whose mesh is not a torch ``DeviceMesh`` over the world is refused
    before any collective. The mesh paths themselves run in the gloo
    worlds of ``tests/test_torch_mp.py``."""
    from repro_torch.dist.policy import NO_SHARDING
    _, cfg, _, model = pair
    _, (_, sub, _) = _graph_pairs(1)
    tb = {k: torch.from_numpy(v) for k, v in sub.items()}
    want = gat.loss_fn(model, tb, cfg)
    for mode in ("allreduce", "dst_partitioned"):
        c = dataclasses.replace(cfg, agg_mode=mode)
        assert torch.equal(gat.loss_fn(model, tb, c, NO_SHARDING), want)
    with pytest.raises(TypeError, match="DeviceMesh"):
        gat.forward(model, tb, cfg, policy=type("P", (), {"mesh": "m"})())

"""The cell catalogue of the port (``launch/cells.py``, ``roofline.py``,
``dryrun.py``, ``perf.py``, ``serve.py::build_sah_retrieval_cell``) held
against the reference's on the CPU.

* ``model_flops`` equals the reference's for every (arch, shape).
* Every cell builds on the meta device, its abstract arguments leaf for
  leaf the reference's ``build_cell(arch, shape, None)``'s (shapes and
  dtypes; parameter leaves through ``convert.reference_layout``, an LM's
  layers stacked). Two differences by design: a decode cache's
  ``length`` is a Python int in the port, and SRP codes are int32 bit
  views of the reference's uint32.
* Cell steps at each arch's smoke config and small dims, from the
  reference's weights (``convert``), against the reference's cell steps:
  float32 outputs within rtol 1e-5 (the LM's within 1e-4, its existing
  tests' float32 tolerance), ids and integers exactly.
* The reckoner counts a kernel as one op on the meta device (its output,
  its own FLOPs at its input dtype), and the dry-run CLI writes the
  record PORT.md lists.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch import cells as jcells
from repro.launch import roofline as jroof
from repro.launch import serve as jserve
from repro.models import gat as jgat
from repro.models import recsys as jrec
from repro.models import transformer as jtf
from repro.train import checkpoint as jckpt
from repro.train import trainer as jtrainer
from repro_torch.configs import base
from repro_torch.kernels import ops
from repro_torch.launch import cells, dryrun, perf, roofline, serve
from repro_torch.models import convert
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.trainer import init_state

SRC = str(Path(__file__).resolve().parents[1] / "src")
CELLS = [(a, s.name) for a in jbase.all_archs() for s in jbase.get(a).shapes]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equals_reference(arch, shape):
    assert roofline.model_flops(arch, shape) == jroof.model_flops(arch, shape)


def _dtype(d) -> str:
    name = str(d).replace("torch.", "")
    return {"uint32": "int32"}.get(name, name)   # codes: int32 bit views


def _port_layout(cell) -> list:
    """The port cell's abstract args as the reference nests its own:
    [(path, shape, dtype)]. The model's parameters stand for the params
    pytree; a train cell's model is its state's parameters too."""
    model, *rest = cell.abstract_args
    names = set(dict(model.named_parameters()))
    args = tuple(rest) if cell.kind == "train" else (
        dict(model.named_parameters()), *rest)
    tree = convert.reference_layout(args, names)
    return [(p, tuple(t.shape), _dtype(t.dtype))
            for p, t in ckpt.flatten_with_paths(tree)
            if isinstance(t, torch.Tensor)]


def _ref_layout(cell) -> list:
    return [(p, tuple(t.shape), _dtype(t.dtype))
            for p, t in jckpt._flatten_with_paths(cell.abstract_args)
            if not p.endswith("length")]   # the port's: a Python int


@pytest.mark.parametrize("arch,shape", CELLS + [("sah", "retrieval_cand")])
def test_abstract_args_match_reference(arch, shape):
    if arch == "sah":
        ref, cell = (jserve.build_sah_retrieval_cell(None),
                     serve.build_sah_retrieval_cell())
    else:
        ref, cell = (jcells.build_cell(arch, shape, None),
                     cells.build_cell(arch, shape))
    assert all(t.device.type == "meta"
               for t in roofline.tensors_of(cell.abstract_args))
    assert _port_layout(cell) == _ref_layout(ref)


# -- cell steps at smoke size, against the reference's ---------------------


def _smoke(arch_id: str, shape_name: str, dims: dict):
    """(reference arch, port arch, reference shape, port shape) with the
    smoke configs and ``dims`` over the published shape's."""
    ja, pa = jbase.get(arch_id), base.get(arch_id)
    ja = dataclasses.replace(ja, make_config=ja.make_smoke_config)
    pa = dataclasses.replace(pa, make_config=pa.make_smoke_config)
    js, ps = ja.shape(shape_name), pa.shape(shape_name)
    return (ja, pa, dataclasses.replace(js, dims={**js.dims, **dims}),
            dataclasses.replace(ps, dims={**ps.dims, **dims}))


def _np(x):
    return (x.detach().float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, dtype=np.float32))


def _lm_cells(kind: str, dims: dict):
    ja, pa, js, ps = _smoke("qwen3-0.6b", kind, dims)
    ref, cell = jcells.build_lm_cell(ja, js, None), cells.build_lm_cell(pa, ps)
    jcfg = ja.make_config()
    tree = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0),
                                                    jcfg))
    model = convert.params_from_jax(tree, cell.abstract_args[0].cfg,
                                    device="cpu")
    return ref, cell, tree, model


def test_lm_train_cell_matches_reference():
    """One step of the LM train cell (chain(clip 1.0, adafactor 3e-4)):
    loss and gradient norm, then every parameter."""
    ref, cell, tree, model = _lm_cells("train_4k", {"seq_len": 32,
                                                    "global_batch": 4})
    rng = np.random.default_rng(1)
    t = rng.integers(0, model.cfg.vocab, (4, 33)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    jo = jcells.default_optimizer("lm")
    jparams = jax.tree.map(jnp.asarray, tree)
    jstate = jtrainer.TrainState(jparams, jo.init(jparams),
                                 jnp.zeros((), jnp.int32))
    jstate, jm = jax.jit(ref.step)(jstate, jax.tree.map(jnp.asarray, batch))
    state = init_state(dict(model.named_parameters()),
                       cells.default_optimizer("lm"))
    state, m = cell.step(model, state, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    got = ckpt.flatten_with_paths(convert.train_state_to_numpy(state).params)
    want = jckpt._flatten_with_paths(jax.tree.map(np.asarray, jstate.params))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=1e-5,
                                   err_msg=path)


def test_lm_prefill_and_decode_cells_match_reference():
    ref, cell, tree, model = _lm_cells("prefill_32k", {"seq_len": 48,
                                                       "global_batch": 2})
    tokens = np.random.default_rng(2).integers(
        0, model.cfg.vocab, (2, 48)).astype(np.int32)
    jl, jc = ref.step(jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens))
    pl, pc = cell.step(model, torch.from_numpy(tokens))
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(pc[name]), np.asarray(jc[name]), **tol)
    assert pc["length"] == int(jc["length"]) == 48

    ref, cell, tree, model = _lm_cells("decode_32k", {"seq_len": 48,
                                                      "global_batch": 2})
    rng = np.random.default_rng(3)
    kv = tuple(cell.abstract_args[1]["k"].shape)
    k, v = (rng.standard_normal(kv).astype(np.float32) for _ in range(2))
    pos = 48 - cells.DECODE_HEADROOM
    tokens = rng.integers(0, model.cfg.vocab, (2,)).astype(np.int32)
    jl, jc = ref.step(jax.tree.map(jnp.asarray, tree),
                      {"k": jnp.asarray(k), "v": jnp.asarray(v),
                       "length": jnp.asarray(pos, jnp.int32)},
                      jnp.asarray(tokens))
    pl, pc = cell.step(model, {"k": torch.from_numpy(k.copy()),
                               "v": torch.from_numpy(v.copy()),
                               "length": pos}, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(pc[name]), np.asarray(jc[name]), **tol)
    assert pc["length"] == int(jc["length"]) == pos + 1


def _molecule_graph(dims: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n, e, n_g = dims["n_nodes"], dims["n_edges"], dims["n_graphs"]
    per = n // n_g
    base_ = (np.arange(e) % n_g) * per
    return {"x": rng.standard_normal((n, dims["d_feat"])).astype(np.float32),
            "src": (base_ + rng.integers(0, per, e)).astype(np.int32),
            "dst": (base_ + rng.integers(0, per, e)).astype(np.int32),
            "edge_mask": rng.random(e) < 0.9,
            "graph_id": (np.arange(n) // per).astype(np.int32),
            "graph_labels": rng.integers(0, dims["n_classes"], n_g)
            .astype(np.int32)}


def test_gat_molecule_cell_matches_reference():
    ja, pa, js, ps = _smoke("gat-cora", "molecule", {})
    ref, cell = jcells.build_gnn_cell(ja, js, None), cells.build_gnn_cell(
        pa, ps)
    jcfg = dataclasses.replace(ja.make_config(), d_in=js.dims["d_feat"],
                               n_classes=js.dims["n_classes"])
    jparams = jgat.init_params(jax.random.PRNGKey(4), jcfg)
    model = convert.gat_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        cell.abstract_args[0].cfg,
                                        device="cpu")
    graph = _molecule_graph(js.dims, 5)
    jo = jcells.default_optimizer()
    jstate = jtrainer.TrainState(jparams, jo.init(jparams),
                                 jnp.zeros((), jnp.int32))
    jstate, jm = jax.jit(ref.step)(jstate, jax.tree.map(jnp.asarray, graph))
    state = init_state(dict(model.named_parameters()),
                       cells.default_optimizer())
    state, m = cell.step(model, state, {k: torch.from_numpy(v)
                                        for k, v in graph.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    got = ckpt.flatten_with_paths(convert.train_state_to_numpy(state).params)
    want = jckpt._flatten_with_paths(jax.tree.map(np.asarray, jstate.params))
    for (path, g), (path2, w) in zip(got, want):
        assert path == path2
        np.testing.assert_allclose(_np(g), w, rtol=1e-5, atol=1e-6,
                                   err_msg=path)


def _recsys_pair(arch_id: str, shape_name: str, dims: dict, seed: int):
    """The two packages' cells at the smoke config, with the reference's
    weights in both."""
    ja, pa, js, ps = _smoke(arch_id, shape_name, dims)
    ref = jcells.build_recsys_cell(ja, js, None)
    cell = cells.build_recsys_cell(pa, ps)
    jcfg = ja.make_config()
    init = {"deepfm": jrec.init_ctr_params, "xdeepfm": jrec.init_ctr_params,
            "din": jrec.init_din_params,
            "two-tower-retrieval": jrec.init_twotower_params}[arch_id]
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    model = convert.recsys_params_from_jax(tree, pa.make_config(),
                                           device="cpu")
    return ref, cell, tree, model


def _ranker_batch(abstract: dict, cfg, rows: int, seed: int) -> dict:
    gen = torch.Generator().manual_seed(seed)
    return {k: v.numpy() for k, v in cells.draw_recsys_batch(
        cfg, abstract, rows, "cpu", gen).items()}


@pytest.mark.parametrize("arch,shape,rows", [
    ("deepfm", "serve_p99", 64), ("xdeepfm", "retrieval_cand", 256)])
def test_ranker_cells_match_reference(arch, shape, rows):
    """DeepFM's serve cell; xDeepFM's retrieval cell, bulk scoring in
    chunks."""
    dims = ({"batch": rows} if shape != "retrieval_cand"
            else {"n_candidates": rows})
    ref, cell, tree, model = _recsys_pair(arch, shape, dims, 6)
    batch = _ranker_batch(cell.abstract_args[1], model.cfg, rows, 7)
    want = ref.step(jax.tree.map(jnp.asarray, tree),
                    jax.tree.map(jnp.asarray, batch))
    got = cell.step(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (rows,)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_two_tower_exact_retrieval_cell_matches_reference():
    ref, cell, tree, model = _recsys_pair(
        "two-tower-retrieval", "retrieval_cand", {"n_candidates": 2048}, 8)
    rng = np.random.default_rng(9)
    feats = np.stack([rng.integers(0, v, 1) for v in
                      model.cfg.user_embedding.vocab_sizes], -1).astype(
        np.int32)
    cand = rng.standard_normal((2048, model.cfg.out_dim)).astype(np.float32)
    jv, ji = ref.step(jax.tree.map(jnp.asarray, tree), jnp.asarray(feats),
                      jnp.asarray(cand))
    pv, pi = cell.step(model, torch.from_numpy(feats), torch.from_numpy(cand))
    assert pi.dtype == torch.int32
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


def _sah_cell_against_reference(monkeypatch, jdtype, dtype):
    """The sketch cell at the smoke two-tower, 65,536 candidates of the
    given dtype: both packages fed the reference's weights, codes (of the
    float32 candidates) and projection."""
    arch = "two-tower-retrieval"
    for reg in (jbase, base):
        spec = reg.get(arch)
        monkeypatch.setitem(reg._REGISTRY, arch, dataclasses.replace(
            spec, make_config=spec.make_smoke_config))
    ref, cell = (jserve.build_sah_retrieval_cell(None, jdtype),
                 serve.build_sah_retrieval_cell(dtype))
    jcfg = jbase.get(arch).make_config()
    tree = jax.tree.map(np.asarray, jrec.init_twotower_params(
        jax.random.PRNGKey(10), jcfg))
    model = convert.recsys_params_from_jax(tree, base.get(arch).make_config(),
                                           device="cpu")
    rng = np.random.default_rng(11)
    n = serve.SAH_CELL_CANDIDATES
    cand = rng.standard_normal((n, jcfg.out_dim)).astype(np.float32)
    codes, proj = jserve.build_candidate_index(jnp.asarray(cand),
                                               jax.random.PRNGKey(12))
    feats = np.stack([rng.integers(0, v, 1) for v in
                      jcfg.user_embedding.vocab_sizes], -1).astype(np.int32)
    jv, ji = ref.step(jax.tree.map(jnp.asarray, tree), jnp.asarray(feats),
                      jnp.asarray(cand).astype(jdtype), codes, proj)
    pv, pi = cell.step(model, torch.from_numpy(feats),
                       torch.from_numpy(cand).to(dtype),
                       torch.from_numpy(np.array(codes).view(np.int32)),
                       torch.from_numpy(np.array(proj)))
    assert pv.dtype == torch.float32 and jv.dtype == jnp.float32
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-6)


def test_sah_retrieval_cell_matches_reference(monkeypatch):
    _sah_cell_against_reference(monkeypatch, jnp.float32, torch.float32)


def test_sah_retrieval_cell_bf16_candidates_match_reference(monkeypatch):
    """``cand_dtype=bfloat16``: bf16 candidate rows re-ranked against the
    float32 user vector, float32 values, as the reference's cell."""
    _sah_cell_against_reference(monkeypatch, jnp.bfloat16, torch.bfloat16)


@pytest.mark.parametrize("arch,shape,dims", [
    ("qwen3-0.6b", "train_4k", {"seq_len": 16, "global_batch": 2}),
    ("qwen3-0.6b", "decode_32k", {"seq_len": 16, "global_batch": 2}),
    ("gat-cora", "minibatch_lg", {"n_nodes": 300, "n_edges": 900,
                                  "batch_nodes": 30}),
    ("din", "serve_p99", {"batch": 8}),
    ("two-tower-retrieval", "retrieval_cand", {"n_candidates": 500})])
def test_materialize_gives_the_abstract_layout(arch, shape, dims):
    """``materialize`` draws real inputs of the abstract args' shapes and
    dtypes on the CPU, and the step runs on them."""
    _, pa, _, ps = _smoke(arch, shape, dims)
    cell = {"lm": cells.build_lm_cell, "gnn": cells.build_gnn_cell,
            "recsys": cells.build_recsys_cell}[pa.family](pa, ps)
    args = cells.materialize(cell, "cpu", torch.Generator().manual_seed(0))
    assert dryrun.same_layout(args, cell.abstract_args)
    assert all(t.device.type == "cpu" for t in roofline.tensors_of(args))
    out = cell.step(*args)
    assert dryrun.same_layout(out, cell.step(*cell.abstract_args))


# -- the reckoner, the dry run and perf ------------------------------------


def test_reckoner_counts_a_kernel_as_the_kernel():
    """On the meta device flash is one op, counted as the kernel: its
    output alone, its FLOPs (those of ``FlopCounterMode``) the kernel's
    causal work, at bf16's rate; the other kernels' FLOPs are theirs."""
    q = torch.empty(2, 4, 256, 64, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 2, 256, 64, dtype=torch.bfloat16, device="meta")
    with roofline.Reckoner((q, k)) as r:
        out = ops.flash_attention(q, k, k)
    assert r.peak_bytes == out.numel() * 2
    with torch.utils.flop_counter.FlopCounterMode(display=False) as fc:
        ops.flash_attention(q, k, k)
    causal = 4 * 2 * 4 * 64 * (256 * 257 // 2)
    assert r.flops == r.tensor_core_flops == fc.get_total_flops() == causal
    with roofline.Reckoner((q, k)) as r:
        ops.flash_attention(q, k, k, causal=False)
    assert r.flops == 4 * 2 * 4 * 64 * 256 * 256

    x, p = (torch.empty(s, device="meta") for s in ((10, 100), (100, 256)))
    live = torch.ones(10, dtype=torch.bool, device="meta")
    qi = torch.empty(10, 100, dtype=torch.int8, device="meta")
    with roofline.Reckoner((x, p, live, qi)) as r:
        codes = ops.srp_hash(x, p)
        assert r.flops == 2 * 10 * 100 * 256
        ops.hamming_scores(codes, codes)
        ops.hamming_nearest(codes, codes, live, 4)
        assert r.flops == 2 * 10 * 100 * 256      # integer work: no FLOPs
        ops.ip_topk(x, x, 3)
        ops.fused_scan(codes, codes, live, qi, x[:, 0], x, n_cand=4)
        assert r.flops == 2 * 10 * 100 * (256 + 10 + 4)
        assert r.tensor_core_flops == 0

    x = torch.empty(64, 64, device="meta")
    with roofline.Reckoner((x,)) as r:
        y = (x @ x).relu()          # the product is freed after relu
        z = torch.mv(y, x[0])
    assert r.peak_bytes == 2 * x.numel() * 4
    assert r.flops == 2 * 64 ** 3 + 2 * 64 * 64 and r.tensor_core_flops == 0
    del z


def test_dryrun_cli_writes_the_record(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gat-cora", "--shape", "molecule", "--out", str(tmp_path)],
        capture_output=True, text=True, env={"PYTHONPATH": SRC,
                                             "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK   gat-cora x molecule")
    rec = json.loads((tmp_path / "gat-cora__molecule__one.json").read_text())
    assert set(rec) == {"arch", "shape", "mesh", "n_devices", "mesh_shape",
                        "reduced", "trace_s", "memory", "fits_one_h100",
                        "fit_bytes", "roofline", "bound_s",
                        "model_flops_global", "note", "useful_flops_ratio"}
    assert set(rec["memory"]) == {"temp_bytes", "argument_bytes",
                                  "argument_bytes_read", "output_bytes",
                                  "per_device_total"}
    assert rec["fits_one_h100"] and rec["n_devices"] == 1
    assert rec["model_flops_global"] == jroof.model_flops("gat-cora",
                                                          "molecule")
    assert rec["roofline"]["collective_s"] == 0
    assert set(rec["roofline"]["coll_bytes_per_dev"]) == set(
        jroof.collective_bytes(""))



def test_dryrun_measure_needs_the_card(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: --measure would run")
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "gat-cora",
                                      "--shape", "molecule", "--measure"])
    assert dryrun.main() == 2
    assert "needs a CUDA device" in capsys.readouterr().err


def test_perf_variants(tmp_path):
    """The one-device variant, and both mesh variants reckoned on one rank
    of the 16x16 production mesh by the mesh dry run (in a process of its
    own): each record written, the mesh ones with their per-device bytes
    and counted collectives, ZeRO-1's state sharded (a rank holds less
    than the replicated parameters and Adafactor state would take)."""
    rec = perf.run_variant("retrieval_sah", str(tmp_path))
    assert rec["memory_per_device"] > 0 and "measured" not in rec
    assert rec["mesh"] == "one" and rec["n_devices"] == 1
    assert json.loads((tmp_path / "retrieval_sah.json").read_text()) == rec
    for variant in perf.MESH_VARIANTS:
        rec = perf.run_variant(variant, str(tmp_path))
        assert json.loads((tmp_path / f"{variant}.json").read_text()) == rec
        assert rec["mesh"] == "single" and rec["n_devices"] == 256
        assert rec["fits_one_h100"] and rec["memory_per_device"] > 0
        coll = rec["roofline"]["coll_bytes_per_dev"]
        assert coll["all-reduce"] > 0 and rec["roofline"]["collective_s"] > 0
    # dst_partitioned: one all-gather of the owned rows a layer and its
    # backward's reduce-scatter, no segment-max pmax
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    with pytest.raises(ValueError, match="reckoned"):
        perf.run_variant("qwen3_zero1", str(tmp_path), measure=True)


def test_mesh_dryrun_cli_writes_one_ranks_record(tmp_path):
    """``dryrun --mesh single`` in a process of its own (its fake process
    group must not touch this one): one rank of the 16x16 mesh, the
    reference's mesh keys, the per-device fit and the collectives' output
    bytes by kind."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gat-cora", "--shape", "molecule", "--mesh", "single", "--out",
         str(tmp_path)],
        capture_output=True, text=True, env={"PYTHONPATH": SRC,
                                             "PATH": "/usr/bin:/bin"},
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK   gat-cora x molecule x single")
    rec = json.loads((tmp_path / "gat-cora__molecule__single.json")
                     .read_text())
    assert rec["mesh"] == "single" and rec["n_devices"] == 256
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    assert rec["memory"]["per_device_total"] > 0 and rec["fits_one_h100"]
    coll = rec["roofline"]["coll_bytes_per_dev"]
    assert set(coll) == set(jroof.collective_bytes(""))
    # the all-reduce mode: pmax, num and den forward, their psums again
    # backward, plus the gradients' psum
    assert coll["all-reduce"] > 0 and coll["all-gather"] == 0
    assert rec["roofline"]["collective_s"] == pytest.approx(
        2 * coll["all-reduce"] / roofline.LINK_BW)
    assert "tiled over 256 ranks" in rec["note"]

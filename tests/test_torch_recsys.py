"""Recsys serving of the PyTorch port (``repro_torch.models.embedding``,
``models.recsys``, ``models.convert.recsys_params_from_jax``, the four
recsys configs and ``launch.serve``) held against the JAX reference on the
CPU, on the smoke configs.

Inputs are made with numpy from a seed: feature ids uniform per field, as
the reference's examples draw them. The weights are the reference's own
``init_*_params`` arrays, carried over bitwise. Tolerances, with reasons:

- Gathers (``flatten_ids``, ``embedding_bag`` with and without weights)
  are exact: a gather and one multiply round the same in both.
- Forwards and losses, float32: rtol 1e-5, atol 1e-5. XLA and PyTorch sum
  the MLP products, the FM squares, the CIN contractions and the softmax
  in different orders; at the smoke widths the two differ by a few ulps
  of values of order 1.
- Codes are int32 bit views of the reference's uint32 and are compared
  exactly. The reference writes its padding's code (all bits set) onto the
  last candidate row (``artifact.py:594-595``, its ``.at[-1]`` wraps);
  the port writes that row's own code, and the test asserts exactly that.
- The scan fed the reference's user vector, codes and projection returns
  the reference's ids exactly, values at rtol 1e-5, atol 1e-6 (the
  re-rank sums 32 products in another order). End to end, from the
  features, each differing id is traced: to a float tie of the two items'
  inner products, or to a query code that differs from the reference's
  in bits whose score lies within rounding (and the towers' difference)
  of 0.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.core import srp as jsrp
from repro.dist.policy import NO_SHARDING
from repro.engine.artifact import KMIPS_KEY_TAG
from repro.engine.artifact import IndexArtifact as JaxArtifact
from repro.engine.config import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import embedding as jemb
from repro.models import recsys as jrec
from repro_torch.configs import base
from repro_torch.engine.artifact import IndexArtifact
from repro_torch.engine.config import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import convert, embedding, recsys

F32_TOL = dict(rtol=1e-5, atol=1e-5)
RERANK_TOL = dict(rtol=1e-5, atol=1e-6)
KEY = jax.random.PRNGKey(19)
B = 6                  # batch rows of a forward
N_CAND = 700           # candidates: one 512-row tile and 324 padding rows
SRC = str(Path(__file__).resolve().parents[1] / "src")
RECSYS = ["deepfm", "xdeepfm", "din", "two-tower-retrieval"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(arch):
    return jbase.get(arch).make_smoke_config(), \
        base.get(arch).make_smoke_config()


def uniform_ids(rng, vocab_sizes, rows):
    """(rows, fields) int32 ids, each field uniform over its vocabulary."""
    return np.stack([rng.integers(0, v, rows) for v in vocab_sizes],
                    -1).astype(np.int32)


def batch_for(arch, jcfg, seed=3):
    """A numpy batch of ``B`` rows for ``arch`` (labels and log_q too)."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 2, B).astype(np.float32)
    if arch in ("deepfm", "xdeepfm"):
        return {"sparse": uniform_ids(rng, jcfg.embedding.vocab_sizes, B),
                "label": label}
    if arch == "din":
        vocab = jcfg.embedding.vocab_sizes
        t = jcfg.seq_len
        lengths = rng.integers(1, t + 1, B)
        return {"hist": rng.integers(0, vocab[0], (B, t)).astype(np.int32),
                "hist_mask": np.arange(t)[None, :] < lengths[:, None],
                "target": rng.integers(0, vocab[0], B).astype(np.int32),
                "profile": uniform_ids(rng, vocab[1:], B), "label": label}
    return {"user_feats": uniform_ids(rng, jcfg.user_embedding.vocab_sizes,
                                      B),
            "item_feats": uniform_ids(rng, jcfg.item_embedding.vocab_sizes,
                                      B),
            "log_q": rng.uniform(-2, 0, B).astype(np.float32)}


def reference_init(arch, jcfg):
    init = {"deepfm": jrec.init_ctr_params, "xdeepfm": jrec.init_ctr_params,
            "din": jrec.init_din_params}.get(arch, jrec.init_twotower_params)
    return init(KEY, jcfg)


def pair(arch):
    """(reference config, port config, reference params, port model with
    the reference's arrays, numpy batch)."""
    jcfg, cfg = configs(arch)
    params = reference_init(arch, jcfg)
    tree = jax.tree.map(np.asarray, params)
    model = convert.recsys_params_from_jax(tree, cfg, device="cpu")
    return jcfg, cfg, params, model, batch_for(arch, jcfg)


def as_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# -- embedding ----------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_flatten_ids_and_embedding_bag_match_reference(weighted):
    jcfg, cfg = configs("deepfm")
    table = np.array(jemb.init_table(KEY, jcfg.embedding))
    rng = np.random.default_rng(5)
    ids = uniform_ids(rng, jcfg.embedding.vocab_sizes, 9)
    weights = rng.uniform(0, 2, ids.shape).astype(np.float32) \
        if weighted else None
    want_rows = jemb.flatten_ids(jnp.asarray(ids), jcfg.embedding)
    rows = embedding.flatten_ids(torch.from_numpy(ids), cfg.embedding)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    want = jemb.embedding_bag(
        jnp.asarray(table), want_rows, NO_SHARDING,
        None if weights is None else jnp.asarray(weights))
    got = embedding.embedding_bag(
        torch.from_numpy(table), rows,
        weights=None if weights is None else torch.from_numpy(weights))
    assert got.shape == (9, cfg.embedding.n_fields, cfg.embedding.dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_embedding_config_and_init_table():
    jcfg, cfg = configs("din")
    e, je = cfg.embedding, jcfg.embedding
    assert (e.n_fields, e.total_rows) == (je.n_fields, je.total_rows)
    np.testing.assert_array_equal(e.offsets, je.offsets)
    assert e.offsets.dtype == je.offsets.dtype
    gen = torch.Generator().manual_seed(0)
    t = embedding.init_table(gen, e, pad_to=64)
    assert t.shape == (-(-e.total_rows // 64) * 64, e.dim)
    assert t.dtype == torch.float32 and abs(float(t.std()) - e.dim ** -0.5) \
        < 0.05 * e.dim ** -0.5


def test_embedding_bag_refuses_a_mesh():
    """A mesh that is not a torch ``DeviceMesh`` is refused (the sharded
    lookup under a real mesh: ``tests/test_torch_mp.py``)."""
    policy = dataclasses.make_dataclass("P", ["mesh"])(mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        embedding.embedding_bag(torch.zeros(4, 2),
                                torch.zeros(3, dtype=torch.int32), policy)


# -- models -------------------------------------------------------------------


@pytest.mark.parametrize("arch", RECSYS)
def test_forward_matches_reference(arch):
    jcfg, cfg, params, model, batch = pair(arch)
    tb, jb = as_torch(batch), as_jax(batch)
    if arch in ("deepfm", "xdeepfm"):
        outs = [(recsys.ctr_forward(model, tb, cfg),
                 jrec.ctr_forward(params, jb, jcfg))]
    elif arch == "din":
        outs = [(recsys.din_forward(model, tb, cfg),
                 jrec.din_forward(params, jb, jcfg))]
    else:
        outs = [(recsys.user_tower(model, tb["user_feats"], cfg),
                 jrec.user_tower(params, jb["user_feats"], jcfg)),
                (recsys.item_tower(model, tb["item_feats"], cfg),
                 jrec.item_tower(params, jb["item_feats"], jcfg))]
        u, v = outs[0][0], outs[1][0]
        outs.append((recsys.retrieval_scores(u, v),
                     jrec.retrieval_scores(outs[0][1], outs[1][1])))
    for got, want in outs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **F32_TOL)


@pytest.mark.parametrize("arch", RECSYS)
def test_loss_matches_reference(arch):
    jcfg, cfg, params, model, batch = pair(arch)
    loss, jloss = {"deepfm": (recsys.ctr_loss, jrec.ctr_loss),
                   "xdeepfm": (recsys.ctr_loss, jrec.ctr_loss),
                   "din": (recsys.din_loss, jrec.din_loss)}.get(
        arch, (recsys.twotower_loss, jrec.twotower_loss))
    got = loss(model, as_torch(batch), cfg)
    want = jloss(params, as_jax(batch), jcfg)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **F32_TOL)


def test_bce_loss_matches_reference():
    rng = np.random.default_rng(2)
    z = (rng.standard_normal(64) * 30).astype(np.float32)
    y = rng.integers(0, 2, 64).astype(np.float32)
    np.testing.assert_allclose(
        recsys.bce_loss(torch.from_numpy(z), torch.from_numpy(y)).numpy(),
        np.asarray(jrec.bce_loss(jnp.asarray(z), jnp.asarray(y))), **F32_TOL)


def test_cin_micro_chunks_equal_one_chunk(monkeypatch):
    """A chunk of 1 row gives what one chunk of the whole batch gives (each
    row's contraction does not depend on its neighbours)."""
    jcfg, cfg, params, model, batch = pair("xdeepfm")
    tb = as_torch(batch)
    whole = recsys.ctr_forward(model, tb, cfg)
    f, d = cfg.embedding.n_fields, cfg.embedding.dim
    monkeypatch.setattr(recsys, "CIN_CHUNK_ELEMS",
                        max(cfg.cin_layers + (f,)) * f * d)
    np.testing.assert_allclose(
        recsys.ctr_forward(model, tb, cfg).detach().numpy(),
        whole.detach().numpy(), rtol=1e-6, atol=1e-7)


def test_port_init_matches_the_references_scales():
    """Torch's draws differ from JAX's; the shapes, dtypes and scales do
    not: the reference's tree converts into the port's init's model."""
    for arch in RECSYS:
        jcfg, cfg = configs(arch)
        init = {"deepfm": recsys.init_ctr_params,
                "xdeepfm": recsys.init_ctr_params,
                "din": recsys.init_din_params}.get(
            arch, recsys.init_twotower_params)
        model = init(torch.Generator().manual_seed(0), cfg, device="cpu")
        tree = jax.tree.map(np.asarray, reference_init(arch, jcfg))
        ref_model = convert.recsys_params_from_jax(tree, cfg, device="cpu")
        for (name, p), (rname, r) in zip(model.named_parameters(),
                                         ref_model.named_parameters()):
            assert name == rname and p.shape == r.shape, name
            if name.endswith(".b"):
                assert not p.any(), name
            else:
                ratio = float(p.std()) / float(r.std())
                assert 0.5 < ratio < 2.0, (name, ratio)


@pytest.mark.parametrize("fault", ["missing", "extra", "misshapen",
                                   "dtype"])
def test_recsys_params_from_jax_rejects_bad_trees(fault):
    jcfg, cfg = configs("xdeepfm")
    tree = jax.tree.map(np.asarray, reference_init("xdeepfm", jcfg))
    if fault == "missing":
        del tree["cin_out"]
    elif fault == "extra":
        tree["mlp"].append({"w": np.zeros((1, 1), np.float32),
                            "b": np.zeros((1,), np.float32)})
    elif fault == "misshapen":
        tree["cin"][1] = tree["cin"][1][:, :-1]
    else:
        tree["linear"] = tree["linear"].astype(np.float64)
    with pytest.raises(ValueError):
        convert.recsys_params_from_jax(tree, cfg, device="cpu")


# -- configs ------------------------------------------------------------------


def _same_value(got, want):
    if isinstance(got, torch.dtype):
        return str(got).removeprefix("torch.") == jnp.dtype(want).name
    if dataclasses.is_dataclass(got):
        return [f.name for f in dataclasses.fields(got)] == [
            f.name for f in dataclasses.fields(want)] and all(
            _same_value(getattr(got, f.name), getattr(want, f.name))
            for f in dataclasses.fields(got))
    return got == want


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_configs_are_the_references(arch):
    spec, jspec = base.get(arch), jbase.get(arch)
    assert ([dataclasses.asdict(s) for s in spec.shapes]
            == [dataclasses.asdict(s) for s in jspec.shapes])
    assert (spec.family, spec.source, spec.notes) == (
        jspec.family, jspec.source, jspec.notes)
    for make in ("make_config", "make_smoke_config"):
        cfg, jcfg = getattr(spec, make)(), getattr(jspec, make)()
        assert type(cfg).__name__ == type(jcfg).__name__
        assert _same_value(cfg, jcfg), (arch, make)


# -- launch/serve -------------------------------------------------------------


@pytest.fixture(scope="module")
def retrieval():
    """The reference's two-tower smoke model and its port; 700 candidate
    vectors from the reference's item tower; the reference's candidate
    index (codes, query projection) and the full forward projection."""
    jcfg, cfg, params, model, _ = pair("two-tower-retrieval")
    rng = np.random.default_rng(11)
    items = uniform_ids(rng, jcfg.item_embedding.vocab_sizes, N_CAND)
    cand = np.array(jrec.item_tower(params, jnp.asarray(items), jcfg))
    jcodes, jproj = jserve.build_candidate_index(jnp.asarray(cand), KEY,
                                                 n_bits=serve.N_BITS)
    kproj = np.array(jsrp.make_projection(
        jax.random.fold_in(KEY, KMIPS_KEY_TAG), cfg.out_dim + 1,
        serve.N_BITS))
    users = uniform_ids(rng, jcfg.user_embedding.vocab_sizes, 5)
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=model, cand=cand,
                jcodes=np.array(jcodes), jproj=np.array(jproj),
                kproj=kproj, users=users)


def test_build_candidate_index_matches_reference_but_the_wrapped_row(
        retrieval):
    cand, jcodes, kproj = (retrieval[k] for k in ("cand", "jcodes",
                                                  "kproj"))
    codes, proj_q = serve.build_candidate_index(
        cand, n_bits=serve.N_BITS, key=np.asarray(KEY), kmips_proj=kproj,
        device="cpu")
    assert codes.dtype == torch.int32 and codes.shape == (N_CAND, 8)
    np.testing.assert_array_equal(proj_q.numpy(), retrieval["jproj"])
    np.testing.assert_array_equal(codes.numpy()[:-1].view(np.uint32),
                                  jcodes[:-1])
    # the wrapped row: the reference's holds the padding's code, all bits
    # set; the port's holds its own, the reference's forward-index code
    assert np.all(jcodes[-1] == 0xFFFFFFFF)
    jidx = JaxArtifact.build(
        jnp.asarray(cand), None, KEY,
        config=jget_config("sah").replace(n_bits=serve.N_BITS)
    ).ensure_kmips_index()
    own = np.asarray(jidx.codes)[np.asarray(jidx.item_ids) == N_CAND - 1]
    np.testing.assert_array_equal(codes.numpy()[-1:].view(np.uint32), own)
    assert not np.array_equal(own[0], jcodes[-1])
    art = IndexArtifact.build(cand, None, key=np.asarray(KEY),
                              kmips_proj=kproj, device="cpu",
                              config=get_config("sah").replace(
                                  n_bits=serve.N_BITS))
    assert torch.equal(art.serving_codes()[0], codes)


def _reference_step(r, user, n_cand, k):
    return jserve.sah_retrieve_step(
        r["params"], jnp.asarray(user[None]), jnp.asarray(r["cand"]),
        jnp.asarray(r["jcodes"]), jnp.asarray(r["jproj"]), r["jcfg"],
        NO_SHARDING, n_cand=n_cand, k=k)


def _port_operands(r):
    return (torch.from_numpy(r["cand"]),
            torch.from_numpy(r["jcodes"].view(np.int32)),
            torch.from_numpy(r["jproj"]))


@pytest.mark.parametrize("n_cand,k", [(64, 10), (512, 100)])
def test_retrieve_on_the_references_user_vector_is_exact(retrieval, n_cand,
                                                         k):
    r = retrieval
    cand, codes, proj = _port_operands(r)
    for user in r["users"]:
        want_v, want_i = _reference_step(r, user, n_cand, k)
        u = jrec.user_tower(r["params"], jnp.asarray(user[None]),
                            r["jcfg"])[0]
        got_v, got_i = serve.retrieve_for_user(
            torch.from_numpy(np.array(u)), cand, codes, proj,
            n_cand=n_cand, k=k)
        assert got_i.dtype == torch.int32 and got_i.shape == (k,)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                   **RERANK_TOL)


def traced_mismatches(u, u_ref, cand, proj, got_ids, want_ids):
    """Positions where the two id lists differ; each must be a float tie
    of the two items' inner products with the reference's user vector
    (widened by the towers' difference), or the port's query code must
    differ from the reference's in bits whose score lies within rounding
    (and the towers' difference) of 0."""
    diff = np.nonzero(got_ids != want_ids)[0]
    if diff.size == 0:
        return 0
    u, u_ref = u.astype(np.float64), u_ref.astype(np.float64)
    du = np.abs(u - u_ref)
    mine = ops.srp_hash(torch.from_numpy(u[None].astype(np.float32)),
                        torch.from_numpy(proj)).numpy()
    theirs = ops.srp_hash(torch.from_numpy(u_ref[None].astype(np.float32)),
                          torch.from_numpy(proj)).numpy()
    flipped = np.nonzero(np.unpackbits(
        (mine ^ theirs).view(np.uint8), bitorder="little"))[0]
    p = proj.astype(np.float64)
    for c in flipped:
        terms = u_ref * p[:, c]
        bound = 8 * len(u) * 2.0 ** -24 * np.abs(terms).sum() \
            + (du * np.abs(p[:, c])).sum()
        assert abs(terms.sum()) <= bound, c
    for pos in diff:
        a = cand[got_ids[pos]].astype(np.float64)
        b = cand[want_ids[pos]].astype(np.float64)
        tol = 8 * len(u) * 2.0 ** -24 * (np.abs(u_ref * a).sum()
                                         + np.abs(u_ref * b).sum()) \
            + (du * (np.abs(a) + np.abs(b))).sum()
        assert abs(u_ref @ a - u_ref @ b) <= tol or flipped.size, pos
    return diff.size


def test_sah_retrieve_step_end_to_end_traced(retrieval):
    r = retrieval
    cand, codes, proj = _port_operands(r)
    n_diff = 0
    for user in r["users"]:
        want_v, want_i = _reference_step(r, user, 64, 10)
        got_v, got_i = serve.sah_retrieve_step(
            r["model"], torch.from_numpy(user[None]), cand, codes, proj,
            r["cfg"], n_cand=64, k=10)
        u = recsys.user_tower(r["model"], torch.from_numpy(user[None]),
                              r["cfg"])[0].detach().numpy()
        u_ref = np.asarray(jrec.user_tower(
            r["params"], jnp.asarray(user[None]), r["jcfg"])[0])
        np.testing.assert_allclose(u, u_ref, **F32_TOL)
        n_diff += traced_mismatches(u, u_ref, r["cand"], r["jproj"],
                                    got_i.numpy(), np.asarray(want_i))
        np.testing.assert_allclose(np.sort(got_v.numpy()),
                                   np.sort(np.asarray(want_v)), **F32_TOL)
    assert n_diff <= 0.05 * 10 * len(r["users"]), n_diff


def test_entry_points_raise_without_a_card(monkeypatch, retrieval):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = configs("two-tower-retrieval")
    gen = torch.Generator().manual_seed(0)
    for make in (lambda: recsys.init_twotower_params(gen, cfg),
                 lambda: recsys.TwoTowerModel(cfg),
                 lambda: recsys.init_ctr_params(gen, configs("deepfm")[1]),
                 lambda: recsys.init_din_params(gen, configs("din")[1]),
                 lambda: serve.build_candidate_index(retrieval["cand"]),
                 lambda: convert.recsys_params_from_jax(
                     {}, cfg, device=None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_recsys_modules_import_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.launch.serve, "
            "repro_torch.models.recsys, repro_torch.models.embedding, "
            "repro_torch.models.convert, repro_torch.configs.deepfm, "
            "repro_torch.configs.xdeepfm, repro_torch.configs.din, "
            "repro_torch.configs.two_tower_retrieval; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": SRC, "PATH": ""},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

"""The example twins (``repro_torch.examples``) on the CPU at small
sizes, held against the reference on the same inputs where the example
computes something the reference computes:

* quickstart, for every preset of ``PAPER_BASELINES``, on arrays the
  reference's ``synthetic.recommendation_data(PRNGKey(0), ...)`` drew:
  the twin's oracle truth equals the reference engine's ``oracle``
  exactly, and every preset's reverse recall against it is 1.0;
* update_stream from the reference's draws: its v1 artifact is the one
  the reference saved (the port's ``IndexArtifact.load`` of that save has
  the same fingerprint), and the audiences at v1, v2 and v3 equal the
  reference's on the same artifact and inserts;
* reverse_recommend's training from the reference's two-tower weights
  (``convert.recsys_params_from_jax``) on the reference example's
  batches: 3 steps' losses within rtol 1e-5;
* train_lm ``tiny``: the configs equal the reference example's, the
  first loss and gradient norm from converted weights within rtol 1e-5,
  and a ``fail_at`` run resumed from its checkpoint equal bit for bit to
  the uninterrupted run;
* each twin's own checks (the reference examples' ``assert``s) hold, and
  ``python -m repro_torch.examples.quickstart --device cpu`` exits 0.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro.configs import base as jbase
from repro.core import cone as jcone
from repro.core import sah as jsah
from repro.core import srp as jsrp
from repro.data import synthetic as jsyn
from repro.engine import config as jconfig
from repro.engine.artifact import KMIPS_KEY_TAG
from repro.engine.engine import RkMIPSEngine as JaxEngine
from repro.models import recsys as jrec
from repro.models import transformer as jtf
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch import PAPER_BASELINES, IndexArtifact
from repro_torch.configs import base
from repro_torch.core import exact, metrics, sah
from repro_torch.examples import (_common, quickstart, reverse_recommend,
                                  serve_async, serve_multitenant,
                                  serve_retrieval, train_lm, update_stream)
from repro_torch.models import convert
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.trainer import init_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEY = jax.random.PRNGKey(0)
N, M, D, K = 512, 2048, 16, 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per test process: the examples' host loops
    issue many tiny ops, and a many-worker run shares the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_example(name: str):
    """The reference's ``examples/<name>.py`` as a module (it imports JAX
    and ``repro``; its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", os.path.join(ROOT, "examples",
                                                  f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus():
    """The reference quickstart's draws (its key split) at a small size,
    queries from the top 2% by norm so that audiences are not empty, the
    reference engine's oracle truth on them, and that engine's artifact
    (built from KEY with update_stream's config)."""
    ki, kq, _ = jax.random.split(KEY, 3)
    items, users = jsyn.recommendation_data(ki, N, M, D)
    queries = jsyn.queries_from_items(kq, items, 4, top_frac=0.02)
    cfg = jconfig.get_config("sah").replace(delta_capacity=64,
                                            serve_batch_size=4)
    eng = JaxEngine(cfg).build(items, users, KEY)
    truth = np.asarray(eng.oracle(queries, K))
    return (np.asarray(items), np.asarray(users), np.asarray(queries),
            truth, eng.artifact)


@pytest.mark.parametrize("method", PAPER_BASELINES)
def test_quickstart_presets_answer_the_references_oracle(corpus, method,
                                                         capsys):
    items, users, queries, truth, _ = corpus
    out = quickstart.run(items, users, queries, k=K, method=method,
                         generator=torch.Generator().manual_seed(0),
                         device="cpu")
    np.testing.assert_array_equal(out["truth"].numpy(), truth)
    assert truth.sum() > 0
    rec = metrics.recall(out["predictions"], out["truth"])
    assert rec.tolist() == [1.0] * 4, (method, rec)
    assert out["audiences"] == out["predictions"].sum(-1).tolist()
    text = capsys.readouterr().out
    assert f"method={method}" in text and "pruning funnel:" in text


def test_update_stream_audiences_equal_the_references(corpus, tmp_path):
    """The reference example's steps on the reference's artifact, and the
    twin's run from the same draws (its v1 is that artifact)."""
    items, users, promoted = (jnp.asarray(x) for x in corpus[:3])
    pick = jax.random.randint(jax.random.PRNGKey(5), (2, 24), 0, N)
    trending = 0.65 * (items[pick[0]] + items[pick[1]])
    jart = corpus[4]
    jart.save(str(tmp_path))
    server = JaxEngine.from_artifact(jart).reverse_server()

    def audiences(results):
        return [int(np.asarray(r.predictions).sum()) for r in results]

    server.submit(promoted)
    want_v1 = audiences(server.flush(K))
    art_v2 = jart.insert_items(trending)
    server.submit(promoted)
    server.swap(art_v2)
    want_v2 = audiences(server.flush(K))
    retired = np.argsort(np.asarray(jnp.linalg.norm(items, axis=-1)))[:8]
    server.swap(art_v2.delete_items(retired.tolist()))
    server.submit(promoted[0])
    want_v3 = audiences(server.flush(K))[0]

    k_idx, k_cone = jsah.build_keys(KEY)
    m_pad = jcone.pad_users(jnp.zeros((M, 1)), 32)[0].shape[0]
    draws = {"key": np.asarray(KEY),
             "proj": np.array(jsrp.make_projection(k_idx, D + 1, 128)),
             "cone_order": np.array(jax.random.permutation(k_cone, m_pad)),
             "kmips_proj": np.array(jsrp.make_projection(
                 jax.random.fold_in(KEY, KMIPS_KEY_TAG), D + 1, 128))}
    loaded = IndexArtifact.load(str(tmp_path), device="cpu",
                                kmips_proj=draws["kmips_proj"])
    out = update_stream.run(*(torch.from_numpy(np.array(x)) for x in
                              (items, users, promoted, trending)),
                            k=K, generator=torch.Generator(), device="cpu",
                            draws=draws)
    assert out["fingerprint_v1"] == loaded.fingerprint == jart.fingerprint
    assert out["retired"] == retired.tolist()
    assert sum(want_v1) > 0
    assert out["audiences_v1"] == want_v1
    assert out["audiences_v2"] == want_v2
    assert out["audience_v3"] == want_v3
    assert out["n_base_v4"] == N + 24 - 8


def test_reverse_recommend_trains_as_the_reference():
    """Three steps of adamw(1e-3) from the reference's weights on the
    reference example's batches (its fold_in draws)."""
    jcfg = jbase.get("two-tower-retrieval").make_smoke_config()
    cfg = base.get("two-tower-retrieval").make_smoke_config()
    jparams = jrec.init_twotower_params(KEY, jcfg)
    model = convert.recsys_params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    batches = []
    for i in range(3):
        kk = jax.random.fold_in(KEY, i)
        batches.append({
            "user_feats": jnp.stack(
                [jax.random.randint(jax.random.fold_in(kk, j), (256,), 0, v)
                 for j, v in enumerate(jcfg.user_embedding.vocab_sizes)],
                -1),
            "item_feats": jnp.stack(
                [jax.random.randint(jax.random.fold_in(kk, 7 + j), (256,), 0,
                                    v)
                 for j, v in enumerate(jcfg.item_embedding.vocab_sizes)],
                -1),
            "log_q": jnp.zeros((256,))})
    opt = jopt.adamw(1e-3)
    step = jax.jit(jtrainer.make_train_step(
        lambda p, b: jrec.twotower_loss(p, b, jcfg), opt))
    state = jtrainer.TrainState(jparams, opt.init(jparams),
                                jnp.zeros((), jnp.int32))
    want = []
    for b in batches:
        state, m = step(state, b)
        want.append(float(m["loss"]))
    got = _common.train_two_tower(
        model, cfg, [{k: torch.from_numpy(np.asarray(v)) for k, v in
                      b.items()} for b in batches], opt_lib.adamw(1e-3))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_reverse_recommend_runs(capsys):
    cfg = base.get("two-tower-retrieval").make_smoke_config()
    out = reverse_recommend.run(cfg, steps=3, n_items=512, m_users=1024,
                                k=K, device="cpu")
    pred, truth = out["predictions"], out["truth"]
    missed = torch.nonzero(truth & ~pred).tolist()
    users_unit = sah.unit_rows(out["users_unit"])
    assert all(exact.float_tie(out["items"], users_unit[u],
                               out["queries"][q], K, out["tie_eps"])
               for q, u in missed)
    _, want = exact.kmips(out["users_unit"], out["queries"], K)
    assert torch.equal(out["fwd_top"].long(), want)
    assert len(out["overlaps"]) == 4
    assert "forward-kMIPS top-10 overlaps only" in capsys.readouterr().out


def test_serve_retrieval_runs():
    cfg = base.get("two-tower-retrieval").make_smoke_config()
    out = serve_retrieval.run(cfg, steps=3, corpus=2048, batch=64,
                              requests=16, k=20, device="cpu")
    assert out["compiles"] == out["compiles_warm"] == 1
    _, want = exact.kmips(out["cand_vecs"], out["users"], 20)
    assert torch.equal(out["exact_ids"].long(), want)
    assert out["sah_ids"].shape == (16, 20)
    assert 0.0 < out["recall"] <= 1.0


def test_serve_async_checks_hold():
    gen = torch.Generator().manual_seed(0)
    items, users = jsyn.recommendation_data(KEY, 512, 256, D)
    items, users = np.asarray(items), np.asarray(users)
    queries = items[np.argsort(-np.linalg.norm(items, axis=1))[:64]]
    trending = 0.65 * (items[:40] + items[40:80])
    out = serve_async.run(torch.from_numpy(items), torch.from_numpy(users),
                          torch.from_numpy(queries),
                          torch.from_numpy(trending), k=K, generator=gen,
                          device="cpu")
    st = out["stats"]
    assert st.compactions == 1 and st.expired == 1 and st.failed == 0
    assert out["n_base_merged"] == 512 + 40 - 2
    assert "closed" in out and "expired" in out


def test_serve_multitenant_checks_hold():
    items, users = jsyn.recommendation_data(KEY, 512, 256, D)
    items, users = np.asarray(items), np.asarray(users)
    queries = items[np.argsort(-np.linalg.norm(items, axis=1))[:24]]
    items = torch.from_numpy(items)
    out = serve_multitenant.run(items, torch.from_numpy(users),
                                torch.from_numpy(queries),
                                serve_multitenant.blitz_probes(items), k=5,
                                generator=torch.Generator().manual_seed(0),
                                device="cpu")
    assert out["traces_after_warmup_0"] == out["traces_after_warmup"] == 0
    assert out["tickets"] == 2 * 28 and len(out["rejected"]) == 2
    st = out["stats"]
    assert st.tenants["prod"].truncated == 0
    assert st.tenants["trial"].truncated == out["n_truncated"] > 0
    # each prod ticket's users to scan and its dispatch's chunks
    assert len(out["prod_scan"]) == 28
    assert any(n > 0 and c > 0 for n, c in out["prod_scan"])


def test_train_lm_matches_the_reference_and_resumes(tmp_path, capsys):
    ref = reference_example("train_lm")
    for name, cfg in train_lm.MODELS.items():
        jcfg = ref.MODELS[name]
        for f in dataclasses.fields(cfg):
            if f.name not in ("dtype", "moe") and hasattr(jcfg, f.name):
                assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
        assert cfg.dtype == torch.float32 and jcfg.dtype == jnp.float32
        assert cfg.n_params == jcfg.n_params
    cfg, jcfg = train_lm.MODELS["tiny"], ref.MODELS["tiny"]
    # the first step from the reference's weights on its first batch
    jparams = jtf.init_params(KEY, jcfg)
    batch = next(jsyn.lm_token_batches(jax.random.PRNGKey(1), 4, 64,
                                       cfg.vocab))
    jo = jopt.chain(jopt.clip_by_global_norm(1.0),
                    jopt.adamw(jopt.cosine_schedule(3e-4, warmup=20,
                                                    total=50)))
    jstate = jtrainer.TrainState(jparams, jo.init(jparams),
                                 jnp.zeros((), jnp.int32))
    _, jm = jax.jit(jtrainer.make_train_step(
        lambda p, b: jtf.lm_loss(p, b, jcfg), jo))(jstate, batch)
    model = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                    device="cpu")
    opt = train_lm.optimizer(50)
    from repro_torch.models import transformer as tf
    step = make_train_step(lambda p, b: tf.lm_loss(model, b), opt)
    _, m = step(init_state(dict(model.named_parameters()), opt),
                {k: torch.from_numpy(np.asarray(v)).long()
                 for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)

    # a crash at step 3, resumed from the step-2 checkpoint
    kw = dict(steps=4, batch=2, seq=32, ckpt_every=2, device="cpu")
    whole = train_lm.run(cfg, **kw)
    ck = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="simulated worker failure"):
        train_lm.run(cfg, ckpt_dir=ck, fail_at=3, **kw)
    resumed = train_lm.run(cfg, ckpt_dir=ck, **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    assert int(resumed["state"].step) == 4
    assert resumed["losses"] == whole["losses"][2:]
    for (name, p), q in zip(resumed["model"].named_parameters(),
                            whole["model"].parameters()):
        assert torch.equal(p, q), name
    got, want = (tree_leaves(r["state"].opt_state) for r in (resumed, whole))
    assert len(got) == len(want) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_quickstart_module_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart", "--device",
         "cpu", "--n-items", "512", "--m-users", "1024", "--queries", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "pruning funnel:" in proc.stdout


def test_examples_import_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.examples.quickstart, "
            "repro_torch.examples.update_stream, "
            "repro_torch.examples.serve_async, "
            "repro_torch.examples.serve_multitenant, "
            "repro_torch.examples.reverse_recommend, "
            "repro_torch.examples.serve_retrieval, "
            "repro_torch.examples.train_lm; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": os.path.join(
                             ROOT, "src"), "PATH": ""}, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

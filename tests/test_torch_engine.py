"""The PyTorch port end to end: ``repro_torch.RkMIPSEngine`` on the CPU,
held against the JAX reference engine and against the port's own exact
oracle.

* The quickstart flow (build, ``query_batch``, ``oracle``, F1) through
  ``RkMIPSEngine(..., device="cpu")``, with the reference's random draws
  injected, gives the reference engine's predictions and funnel, except at
  users traced to float ties.
* Recall is 1.0 against the exact oracle: SAH's "no" is certified (a
  lane's count only counts exact inner products above tau), so SAH can
  only over-admit, up to float ties, which are traced one by one.
* The default device is the card, and without one the engine raises.
* ``import repro_torch`` pulls in neither ``jax`` nor ``repro``.
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

from repro.core import cone as jcone
from repro.core import exact as jexact
from repro.core import metrics as jmetrics
from repro.core import sah as jsah
from repro.core import srp as jsrp
from repro.engine import config as jconfig
from repro.engine.engine import RkMIPSEngine as JaxEngine
from repro_torch import EngineConfig, RkMIPSEngine, get_config
from repro_torch.core import exact, metrics
from repro_torch.data import synthetic
from repro_torch.engine import config as tconfig
from test_torch_core import mf_data
from test_torch_sah import reference_index_arrays, trace

N, M, D = 1000, 2000, 16
CFG = dict(k_max=50, tile=256)
SRC = str(Path(__file__).resolve().parents[1] / "src")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's host loops issue many tiny ops: one intra-op thread per
    test process keeps a many-worker run from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flow():
    """Both engines built on one corpus with the same random draws."""
    items, users = mf_data(10, N, M, D)
    order = np.argsort(-np.linalg.norm(items, axis=1), kind="stable")
    rng = np.random.default_rng(2)
    queries = items[order[rng.choice(int(0.03 * N), 4, replace=False)]]
    key = jax.random.PRNGKey(0)
    jeng = JaxEngine(jconfig.get_config("sah").replace(**CFG)).build(
        jnp.asarray(items), jnp.asarray(users), key)
    k_idx, k_cone = jsah.build_keys(key)
    proj = np.array(jsrp.make_projection(k_idx, D + 1, 128))
    m_pad = jcone.pad_users(jnp.zeros((M, 1)), 32)[0].shape[0]
    perm = np.array(jax.random.permutation(k_cone, m_pad))
    teng = RkMIPSEngine(get_config("sah").replace(**CFG), device="cpu")
    teng.build(items, users, proj=proj, cone_order=perm)
    return items, users, queries, jeng, teng, {}


def port_answer(flow, k):
    """The port engine's (query_batch result, oracle) at k, computed once."""
    _, _, queries, _, teng, memo = flow
    if k not in memo:
        memo[k] = (teng.query_batch(queries, k), teng.oracle(queries, k))
    return memo[k]


@pytest.mark.parametrize("k", [10, 50])
def test_quickstart_flow_matches_reference_engine(flow, k):
    items, users, queries, jeng, teng, _ = flow
    want = jeng.query_batch(jnp.asarray(queries), k)
    got, truth = port_answer(flow, k)
    assert got.predictions.shape == (len(queries), M)
    arrays = reference_index_arrays(jeng.index)
    real = arrays["index/user_mask"]
    lane_of = {int(u): j for j, u in reversed(list(enumerate(
        arrays["index/user_ids"]))) if real[j]}
    diff = np.argwhere(np.asarray(want.predictions)
                       != got.predictions.numpy())
    for qi, u in diff:
        trace(arrays, teng.index, queries[qi], k, [lane_of[int(u)]])
    assert len(diff) <= 0.001 * got.predictions.numel()
    for f in ("queries", "blocks_total", "blocks_alive", "users_total",
              "users_alive", "decided_no_lb", "decided_yes_norm",
              "scan_lanes", "truncated"):
        assert getattr(got.funnel, f) == getattr(want.funnel, f), f
    if k == 50:
        assert got.funnel.scan_lanes > 0
    f1_t = metrics.f1_score(got.predictions, truth)
    f1_j = jmetrics.f1_score(want.predictions, jeng.oracle(
        jnp.asarray(queries), k))
    np.testing.assert_allclose(f1_t.numpy(), np.asarray(f1_j), atol=1e-3)


@pytest.mark.parametrize("k", [1, 10, 50])
def test_recall_is_one_against_the_exact_oracle(flow, k):
    items, users, queries, _, _, _ = flow
    res, truth = port_answer(flow, k)
    missed = torch.nonzero(truth & ~res.predictions).tolist()
    unit = torch.from_numpy(users / np.linalg.norm(users, axis=1,
                                                   keepdims=True))
    for qi, u in missed:
        assert exact.float_tie(torch.from_numpy(items), unit[u],
                               torch.from_numpy(queries[qi]), k, 1e-5)
    rec = metrics.recall(res.predictions, truth)
    assert float(rec.min()) == 1.0 or missed
    assert float(metrics.f1_score(res.predictions, truth).mean()) > 0.9


def test_oracle_matches_reference_oracle(flow):
    items, users, queries, jeng, _, _ = flow
    want = np.asarray(jeng.oracle(jnp.asarray(queries), 10))
    got = port_answer(flow, 10)[1].numpy()
    unit = torch.from_numpy(users / np.linalg.norm(users, axis=1,
                                                   keepdims=True))
    for qi, u in np.argwhere(want != got):
        assert exact.float_tie(torch.from_numpy(items), unit[u],
                               torch.from_numpy(queries[qi]), 10, 1e-5)
    small = exact.rkmips_batch(torch.from_numpy(items),
                               unit[:300], torch.from_numpy(queries), 10,
                               1e-5)
    assert torch.equal(small, port_answer(flow, 10)[1][:, :300])


def test_float_tie_flags_only_decisions_at_the_threshold():
    u = torch.tensor([1.0, 0.0])
    q = torch.tensor([0.5, 0.5])                      # tau = 0.5
    clear = torch.tensor([[0.9, 0.0], [0.1, 0.0], [0.2, 0.3]])
    assert not exact.float_tie(clear, u, q, 1)        # one item beats tau
    assert not exact.float_tie(clear, u, q, 2)
    at_tau = torch.tensor([[0.9, 0.0], [0.5 + 1e-9, 0.0], [0.1, 0.0]])
    assert exact.float_tie(at_tau, u, q, 2)           # 1 or 2 beat tau
    assert not exact.float_tie(at_tau, u, q, 3)       # < 3 either way


def test_single_query_equals_batch_row(flow):
    _, _, queries, _, teng, _ = flow
    batch = port_answer(flow, 10)[0]
    one = teng.query(queries[2], 10)
    assert torch.equal(one.predictions, batch.predictions[2])
    assert int(one.stats.n_scan) == int(batch.stats.n_scan[2])
    assert one.funnel.queries == 1


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert RkMIPSEngine("sah").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        RkMIPSEngine("sah")
    assert not torch.backends.cuda.matmul.allow_tf32


def test_engine_rejects_bad_use():
    eng = RkMIPSEngine("sah", device="cpu")
    with pytest.raises(RuntimeError, match="not built"):
        eng.query_batch(np.ones((1, 4), np.float32), 1)
    items, users = mf_data(1, 300, 200, 8)
    with pytest.raises(ValueError, match="dimensionality"):
        eng.build(items, users[:, :4])
    with pytest.raises(ValueError, match="floating dtype"):
        eng.build(items.astype(np.int32), users)
    eng.build(items, users, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="outside"):
        eng.query_batch(items[:2], 51)
    with pytest.raises(NotImplementedError, match="next slice"):
        RkMIPSEngine(get_config("sah").replace(scan_precision="int8"),
                     device="cpu").build(items, users)
    with pytest.raises(TypeError):
        RkMIPSEngine(3, device="cpu")


def test_config_is_a_field_for_field_copy():
    ref_fields = [(f.name, f.default) for f in
                  dataclasses.fields(jconfig.EngineConfig)]
    mine = [(f.name, f.default) for f in dataclasses.fields(EngineConfig)]
    assert mine == ref_fields
    assert tconfig.method_names() == jconfig.method_names()
    for name in jconfig.method_names():
        assert (dataclasses.asdict(get_config(name))
                == dataclasses.asdict(jconfig.get_config(name)))
        assert tconfig.display_name(name) == jconfig.display_name(name)
    assert tconfig.PAPER_BASELINES == jconfig.PAPER_BASELINES
    for bad in (dict(k_max=0), dict(b=1.0), dict(n_bits=48),
                dict(scan="dense"), dict(n_top=3)):
        with pytest.raises(ValueError):
            EngineConfig(**bad)
        with pytest.raises(ValueError):
            jconfig.EngineConfig(**bad)


def test_synthetic_data_shapes_and_query_draw():
    g = torch.Generator().manual_seed(4)
    items, users = synthetic.recommendation_data(g, 500, 300, 12,
                                                 device="cpu")
    assert items.shape == (500, 12) and users.shape == (300, 12)
    assert items.dtype == torch.float32 and bool((items >= 0).all())
    q = synthetic.queries_from_items(g, items, 7, top_frac=0.1)
    norms = torch.linalg.norm(items, dim=-1)
    cut = torch.sort(norms, descending=True).values[49]
    assert q.shape == (7, 12)
    assert bool((torch.linalg.norm(q, dim=-1) >= cut).all())
    again = synthetic.recommendation_data(torch.Generator().manual_seed(4),
                                          500, 300, 12, device="cpu")
    assert torch.equal(again[0], items)
    assert synthetic.PAPER_DATASETS["netflix"].m_users == 480189


def test_f1_matches_reference():
    rng = np.random.default_rng(5)
    pred, truth = rng.random((6, 40)) < 0.3, rng.random((6, 40)) < 0.3
    pred[0], truth[0] = False, False
    truth[1] = False
    got = metrics.f1_score(torch.from_numpy(pred), torch.from_numpy(truth))
    want = jmetrics.f1_score(jnp.asarray(pred), jnp.asarray(truth))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    ref_exact = jexact.rkmips_batch(jnp.ones((3, 2)), jnp.ones((2, 2)),
                                    jnp.ones((1, 2)), 1)
    assert np.asarray(ref_exact).shape == (1, 2)


def test_import_pulls_in_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch, repro_torch.core.sah, "
            "repro_torch.data.synthetic, repro_torch.kernels.ops; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": SRC, "PATH": ""},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

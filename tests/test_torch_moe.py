"""The MoE FFN of the PyTorch port (``repro_torch.models.moe``) held
against the JAX reference's mesh-less path on the CPU.

Inputs and weights are made with numpy from a seed, the weights with the
names, shapes, dtypes and scales of the reference's ``init_moe_params``,
and loaded into both packages bitwise. (The LM tests hold the whole MoE
model on the reference's own ``init_params`` arrays.)
Tolerances, with reasons:

- float32 outputs and the aux loss: rtol 1e-4, atol 1e-4 (the LM tests'
  ``F32_TOL``): XLA and PyTorch sum the expert GEMMs and the combine in
  different orders (measured differences ~1e-6).
- The routing is discrete and is held exactly: the experts chosen
  (``top_e``), the dispatch slots, ``keep`` and the number of dropped
  assignments. Ties in the router's probabilities (forced below by zero
  router columns) go to the lower expert id on both sides.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import moe as jmoe

from repro_torch.models import moe

SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
TOL = dict(rtol=1e-4, atol=1e-4)
NO_SHARDING = jmoe.ShardingPolicy(mesh=None, rules={})


def _pair(d, e, k, f, cf, seed, zero_cols=()):
    """The reference's and the port's MoE parameters and config; the
    router columns ``zero_cols`` are set to 0 (exactly tied logits)."""
    jcfg = jmoe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=f,
                          capacity_factor=cf)
    cfg = moe.MoEConfig(n_experts=e, top_k=k, d_ff_expert=f,
                        capacity_factor=cf)
    # the reference's leaves (names, shapes, dtypes) at its scales, drawn
    # by numpy: jitting jax.random's draws costs ~2 s a shape on the CPU
    shapes = jax.eval_shape(lambda key: jmoe.init_moe_params(key, d, jcfg),
                            jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    scale = {"router": d ** -0.5, "w_in": d ** -0.5, "w_gate": d ** -0.5,
             "w_out": f ** -0.5}
    params = {name: (rng.standard_normal(sd.shape) * scale[name]).astype(
        sd.dtype) for name, sd in shapes.items()}
    params["router"][:, list(zero_cols)] = 0.0
    m = moe.MoE(d, cfg, torch.float32, "cpu")
    m.load_state_dict({name: torch.from_numpy(a)
                       for name, a in params.items()})
    return jcfg, cfg, params, m


def _reference(x, params, jcfg, capacity):
    """The reference's ``moe_ffn`` and the routing steps its
    ``_moe_local`` runs, in one jit: (out, aux, top_e, slot, keep)."""
    @jax.jit
    def run(x, params):
        out, aux = jmoe.moe_ffn(x, params, jcfg, NO_SHARDING)
        x2d = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(x2d @ params["router"], axis=-1)
        _, top_e = jax.lax.top_k(probs, jcfg.top_k)
        slot, keep = jmoe._dispatch_indices(top_e.reshape(-1),
                                            jcfg.n_experts, capacity)
        return out, aux, top_e, slot, keep

    return tuple(np.asarray(a) for a in run(
        jnp.asarray(x), jax.tree.map(jnp.asarray, params)))


CASES = {
    # name: (d, E, k, F, capacity factor, (B, S), zero router columns)
    "no_drop": (8, 4, 2, 16, 100.0, (2, 6), ()),
    "default_capacity": (16, 8, 2, 32, 1.25, (3, 20), ()),
    "capacity_drops": (4, 2, 1, 8, 0.25, (1, 16), ()),
    "ties": (16, 8, 2, 24, 1.25, (2, 24), (0, 2, 4, 6)),
    "all_tied": (8, 4, 2, 8, 1.0, (2, 8), (0, 1, 2, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_reference(case):
    d, e, k, f, cf, (b, s), zero_cols = CASES[case]
    jcfg, cfg, params, m = _pair(d, e, k, f, cf, seed=len(case),
                                 zero_cols=zero_cols)
    x = np.random.default_rng(len(case)).standard_normal(
        (b, s, d)).astype(np.float32)
    t = b * s
    cap = moe.expert_capacity(cfg, t)
    assert cap == max(k, int(cf * t * k / e))
    out, aux, top_e, slot, keep = _reference(x, params, jcfg, cap)
    with torch.no_grad():
        out_t, aux_t = moe.moe_ffn(torch.from_numpy(x), m, cfg)
    np.testing.assert_allclose(out_t.numpy(), out, **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux), **TOL)
    _, top_e_t, _, slot_t, keep_t = moe.route(
        torch.from_numpy(x.reshape(t, d)), m.router.detach(), cfg, cap)
    np.testing.assert_array_equal(top_e_t.numpy(), top_e)
    np.testing.assert_array_equal(slot_t.numpy(), slot)
    np.testing.assert_array_equal(keep_t.numpy(), keep)
    assert int((~keep_t).sum()) == int((~keep).sum())
    if case == "no_drop":
        assert keep.all()
    if case in ("capacity_drops", "all_tied"):
        assert not keep.all()
    if zero_cols:
        # a token whose top-k holds tied probabilities takes the lower ids
        probs = torch.softmax(torch.from_numpy(x.reshape(t, d))
                              @ m.router.detach(), -1)
        picked = torch.gather(probs, 1, top_e_t)
        for row, p in zip(top_e_t.tolist(), picked):
            for j in range(1, k):
                if p[j] == p[j - 1]:
                    assert row[j] > row[j - 1]
    if case == "all_tied":
        np.testing.assert_array_equal(top_e, np.tile(np.arange(k), (t, 1)))


def test_moe_no_drop_equals_dense_expert_mix():
    """With capacity >= all tokens the port's MoE output equals every
    token routed through its top-k experts densely (the reference's
    ``test_moe_no_drop_equals_dense_expert_mix``)."""
    _, cfg, _, m = _pair(8, 4, 2, 16, 100.0, seed=0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 6, 8)).astype(np.float32))
    with torch.no_grad():
        out, aux = moe.moe_ffn(x, m, cfg)
        x2 = x.reshape(-1, 8)
        probs = torch.softmax(x2 @ m.router, -1)
        top_p, top_e = torch.topk(probs, 2)
        gates = top_p / top_p.sum(-1, keepdim=True)
        ref = torch.zeros_like(x2)
        for e in range(4):
            h = (torch.nn.functional.silu(x2 @ m.w_gate[e])
                 * (x2 @ m.w_in[e]))
            w = torch.where(top_e == e, gates, 0.0).sum(-1)
            ref = ref + (h @ m.w_out[e]) * w[:, None]
    np.testing.assert_allclose(out.reshape(-1, 8).numpy(), ref.numpy(),
                               atol=1e-5)
    assert float(aux) > 0.0


def test_moe_capacity_drops_tokens():
    """Over-capacity tokens get a zero expert output: 2 experts x
    capacity 2 keep 4 of 16 single-choice tokens."""
    _, cfg, _, m = _pair(4, 2, 1, 8, 0.25, seed=1)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 16, 4)).astype(np.float32))
    with torch.no_grad():
        out, _ = moe.moe_ffn(x, m, cfg)
    zero_rows = int((out.reshape(-1, 4) == 0).all(-1).sum())
    assert moe.expert_capacity(cfg, 16) == 2
    assert zero_rows >= 12


def test_dispatch_indices_match_reference_and_slots_are_unique():
    ids = np.asarray([0, 1, 0, 1, 0, 2, 2, 1, 3, 0], np.int32)
    for cap in (1, 2, 3, 10):
        slot, keep = moe._dispatch_indices(torch.from_numpy(ids).long(), 4,
                                           cap)
        jslot, jkeep = jmoe._dispatch_indices(jnp.asarray(ids), 4, cap)
        np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        kept = slot[keep].tolist()
        assert len(set(kept)) == len(kept)
        for e in range(4):
            assert int(((torch.from_numpy(ids) == e) & keep).sum()) <= cap
        # the stable sort keeps each expert's earliest assignments
        for e in range(4):
            rows = np.flatnonzero(ids == e)
            np.testing.assert_array_equal(keep.numpy()[rows],
                                          np.arange(len(rows)) < cap)


def test_moe_params_draw_at_the_references_scales():
    cfg = moe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=64)
    m = moe.init_moe_params(torch.Generator().manual_seed(0), 128, cfg,
                            torch.bfloat16, "cpu")
    assert m.router.dtype == torch.float32           # kept in float32
    assert m.w_in.dtype == m.w_out.dtype == torch.bfloat16
    assert dict((n, tuple(p.shape)) for n, p in m.named_parameters()) == {
        "router": (128, 8), "w_in": (8, 128, 64), "w_gate": (8, 128, 64),
        "w_out": (8, 64, 128)}
    for p, scale in ((m.router, 128 ** -0.5), (m.w_in, 128 ** -0.5),
                     (m.w_out, 64 ** -0.5)):
        assert abs(float(p.detach().float().std()) / scale - 1) < 0.05


def test_moe_modules_import_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.models.moe, "
            "repro_torch.configs.olmoe_1b_7b, repro_torch.configs.dbrx_132b, "
            "repro_torch.configs.mistral_nemo_12b; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
            "m.startswith('repro.')); print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env={"PYTHONPATH": SRC, "PATH": ""},
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr

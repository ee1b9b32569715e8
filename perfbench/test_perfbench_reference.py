"""The yardstick's pieces on the CPU: the frozen generator pinned, the
plain reference against the port (its plain kernels) on a tiny index,
the TF32 rounding, the roofline arithmetic against hand counts of one
tile step, and the busy-time arithmetic."""

import pytest
import torch

from perfbench.data import synthetic
from perfbench.harness import traffic
from perfbench.reference import kmips as ref
from perfbench.harness.trace import Recorder, Session
from perfbench.roofline import busy, peaks, scan

SEED = 2 ** 31 + 977


def test_the_generator_is_pinned():
    """A change to the program's generator cannot move these draws."""
    g = torch.Generator()
    g.manual_seed(12345)
    items, users = synthetic.recommendation_data(g, 5, 7, 4)
    assert [float(x).hex() for x in items[0]] == [
        "0x1.bdb6720000000p-1", "0x1.3f2c2c0000000p+1",
        "0x1.2a82e80000000p+1", "0x1.a18d340000000p+0"]
    assert [float(x).hex() for x in users[-1]] == [
        "0x1.058b080000000p+1", "0x1.3532d80000000p-1",
        "0x1.e633ee0000000p-1", "0x1.bf228a0000000p+0"]
    assert float(items.double().sum()).hex() == "0x1.a68344b800000p+4"
    assert float(users.double().sum()).hex() == "0x1.5007247000000p+5"


def _tiny():
    g = torch.Generator()
    g.manual_seed(SEED)
    return synthetic.recommendation_data(g, 2000, 3000, 100)


def test_the_reference_agrees_with_the_port_on_a_tiny_index():
    from repro_torch.engine import RkMIPSEngine
    items, users = _tiny()
    g = torch.Generator()
    g.manual_seed(SEED)
    eng = RkMIPSEngine("sah", device="cpu").build(items, users, g)
    q = traffic.norm_pool(items, [0.0, 0.02], 16)[:16]
    pred = eng.query_batch(items[q], 10).predictions
    uu = ref.unit_rows(users)
    truth = ref.reverse_answers(ref.kth_values(items, uu, 10), uu,
                                items[q], 1e-5)
    assert truth.any()
    diff = (pred != truth).nonzero()
    assert ref.tied(items, uu[diff[:, 1]], items[q][diff[:, 0]], 10,
                    1e-5).all()
    oracle = eng.oracle(items[q], 10)
    diff = (oracle != truth).nonzero()
    assert ref.tied(items, uu[diff[:, 1]], items[q][diff[:, 0]], 10,
                    1e-5).all()
    # forward: the port's exact scan returns the reference's top-k
    exact = RkMIPSEngine("exact", device="cpu").build(items, None, g)
    res = exact.kmips(users[:64], 10)
    vals, ids = ref.topk(items, users[:64], 10)
    assert (res.ids.long() == ids).float().mean() > 0.99
    torch.testing.assert_close(res.values, vals, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ref.pair_values(items, users[:64], ids),
                               vals.double(), rtol=1e-5, atol=1e-5)


def test_reverse_traffic_is_whole_passes_over_the_same_pool():
    items, _ = _tiny()
    pool = traffic.norm_pool(items, [0.0, 0.02], 16)
    assert pool.numel() == 32           # 40 items cut to whole batches
    norms = torch.linalg.norm(items, dim=-1)
    assert norms[pool].min() >= norms.topk(40).values[-1]
    for seed in (SEED, SEED + 1):
        draws = traffic.ItemDraws(pool, 16, seed)
        for _ in range(3):
            one_pass = torch.cat([draws.next(), draws.next()])
            assert draws.at_pass_end
            assert torch.equal(one_pass.sort().values, pool.sort().values)
    a = traffic.ItemDraws(pool, 16, SEED).next()
    assert torch.equal(a, traffic.ItemDraws(pool, 16, SEED).next())
    assert not torch.equal(a, traffic.ItemDraws(pool, 16, SEED + 1).next())


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -3.0 - 2 ** -12])
    assert ref.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                                    -3.0]


def test_the_roofline_counts_one_tile_step_by_hand():
    # one chunk of 256 lanes, one step over a 512-row tile, W = 4 words
    w = scan.reverse(chunks=1, tile_steps=1, chunk=256, tile=512,
                     n_bits=128, n_cand=64, d=100)
    hash_fp = 2 * 256 * 100 * 128
    rerank_fp = 2 * 256 * 64 * 100
    assert w.fp32 == hash_fp + rerank_fp
    assert w.int32 == 2 * 256 * 512 * 4
    hash_bytes = 256 * 100 * 4 + 100 * 128 * 4 + 256 * 4 * 4
    step_bytes = (512 * 4 * 4 + 512 + 512 * 100 * 4 + 256 * 4 * 4
                  + 256 * 100 * 4 + 256 * 64 * 4)
    assert w.bytes == hash_bytes + 256 * 5 + step_bytes
    t, bound = peaks.least_seconds(w)
    assert bound == "bytes" and t == w.bytes / peaks.HBM_BYTES_PER_S
    f = scan.forward(batches=1, queries=256, tile_steps=1, tile=512,
                     n_bits=128, n_cand=64, d=100, k=10)
    assert f.fp32 == hash_fp + rerank_fp
    assert f.bytes == hash_bytes + step_bytes + 256 * 10 * 8


def test_busy_time_is_the_union_of_device_intervals():
    ev = [busy.DeviceEvent("a", 0.0, 10.0), busy.DeviceEvent("b", 5.0, 12.0),
          busy.DeviceEvent("c", 20.0, 21.0), busy.DeviceEvent("a", 40.0, 45.0)]
    assert busy.busy_seconds(ev) == pytest.approx(18e-6)
    assert busy.top_ops(ev, 2) == [["a", pytest.approx(15e-6)],
                                   ["b", pytest.approx(7e-6)]]
    gaps = busy.idle_gaps(ev, "execute")
    assert gaps == [["execute after c", pytest.approx(19e-6)],
                    ["execute after b", pytest.approx(8e-6)]]


def test_a_session_with_no_device_work_adds_only_its_wall_time():
    rec = Recorder("cpu")
    assert rec.session_totals() == (None, 0)
    rec.sessions.append(Session("execute", 0.5, []))
    assert rec.session_totals() == (None, 0.5)
    rec.sessions += [Session("plan", 0.25, [busy.DeviceEvent("a", 0, 2e5)]),
                     Session("execute", 0.5, [busy.DeviceEvent("b", 0, 1e5)])]
    assert rec.session_totals() == (pytest.approx(0.3), 1.25)
    assert rec.session_totals("execute") == (pytest.approx(0.1), 1.0)

"""The harness driven end to end on the CPU at a tiny size (the port's
plain kernels; the check for a card is skipped by calling ``run.run``
with ``device="cpu"``): sound runs come out correct, the control comes
out not correct, and a run whose timed path is broken underneath comes
out not correct, once for each fault a cell can have."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import run as bench
from perfbench.tools import control, faults

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 977            # past 32 signed bits
TINY = {"n_items": 2000, "m_users": 3000, "d": 100}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A root holding a tiny configuration, a tiny forward mix and a
    BENCHMARK.json whose cells run them; the limits are the real
    configuration's."""
    root = tmp_path_factory.mktemp("tiny")
    for d in ("configs", "traffic"):
        (root / d).mkdir()
    cfg = json.loads((ROOT / "perfbench/configs/netflix.json").read_text())
    cfg.update(name="tiny", **TINY)
    (root / "configs/tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "perfbench/traffic/forward_k10.json")
                     .read_text())
    mix.update(batch=256, keep_every=2)
    (root / "traffic/forward_k10.json").write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [
        {"name": "tiny.reverse", "config": "tiny",
         "traffic": "reverse_top2_k10", "chips": 1, "why": "test"},
        {"name": "tiny.forward", "config": "tiny", "traffic": "forward_k10",
         "chips": 1, "why": "test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [
                "tiny.reverse" if "reverse" in w else "tiny.forward"
                for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def _run(tiny, cell, trace=False):
    return bench.run(cell, SEED, 0.3, trace, device="cpu",
                     bench=tiny / "BENCHMARK.json", roots=[tiny])


@pytest.mark.parametrize("cell", ["tiny.reverse", "tiny.forward"])
def test_a_sound_run_is_correct_and_prints_the_contract_keys(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert len(out["metrics"]) == 2
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", ["tiny.reverse", "tiny.forward"])
def test_a_traced_run_reads_its_counters(tiny, cell):
    out = _run(tiny, cell, trace=True)
    assert out["correct"], out
    assert "index_build_s" in out["metrics"]
    if cell == "tiny.reverse":
        assert out["metrics"]["scan_lanes_per_query"]["value"] > 0
        assert out["metrics"]["plan_ms_per_query"]["value"] > 0
    else:
        assert out["metrics"]["forward_tiles_per_batch"]["value"] >= 1
    # no device on the CPU: the trace's readers find nothing to read
    assert not any("roofline" in m or "idle" in m for m in out["metrics"])


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in ("tiny.reverse", "tiny.forward")
    for fault in faults.FAULTS
    # the top 2% items' audiences hold every lane the tiny reverse cell
    # scans, so candidates that find no beater change no answer there
    if (cell, fault) != ("tiny.reverse", "wrong_candidates")])
def test_a_broken_timed_path_is_not_correct(tiny, cell, fault, monkeypatch):
    faults.plant(fault, monkeypatch.setattr)
    out = _run(tiny, cell)
    assert not out["correct"], out
    assert out["failed"] > 0


@pytest.mark.parametrize("cell", ["tiny.reverse", "tiny.forward"])
def test_the_control_is_not_correct(tiny, cell):
    """The reference in the program's place, in TF32 (the precision below
    the configuration's float32), reads over a limit; the program, read
    by the same tool, does not."""
    checks, _, _, limits = control.read(
        cell, SEED, "control", 3, device="cpu",
        bench_file=tiny / "BENCHMARK.json", roots=[tiny])
    assert any(checks[n] > limits[n] for n in checks), checks
    checks, failed, _, limits = control.read(
        cell, SEED, "program", 3, device="cpu",
        bench_file=tiny / "BENCHMARK.json", roots=[tiny])
    assert all(checks[n] <= limits[n] for n in checks) and not failed, checks


def test_a_fault_reads_wrong_candidates_as_missed_items(tiny, monkeypatch):
    """Wrong candidates keep every value right: only ``recall_miss``
    catches them."""
    faults.plant("wrong_candidates", monkeypatch.setattr)
    checks, failed, _, limits = control.read(
        "tiny.forward", SEED, "wrong_candidates", 2, device="cpu",
        bench_file=tiny / "BENCHMARK.json", roots=[tiny])
    assert checks["value_err"] <= limits["value_err"], checks
    assert checks["recall_miss"] > limits["recall_miss"], checks
    assert failed > 0


def _entry(monkeypatch, capsys, cuda: bool, loaded: str | None):
    import sys
    import types
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: int(cuda))
    monkeypatch.setattr(bench, "run", lambda *a, **k: {"checks": {}})
    if loaded:
        monkeypatch.setitem(sys.modules, loaded, types.ModuleType(loaded))
    rc = bench.main(["--workload", "netflix.forward_k10", "--seed",
                     str(SEED), "--seconds", "1", "--trace", "0"])
    return rc, capsys.readouterr().out


def test_the_entry_prints_no_result_without_a_card(monkeypatch, capsys):
    assert _entry(monkeypatch, capsys, False, None) == (2, "")


def test_the_entry_prints_no_result_once_the_jax_package_is_loaded(
        monkeypatch, capsys):
    assert _entry(monkeypatch, capsys, True, "repro.core") == (3, "")

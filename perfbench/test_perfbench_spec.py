"""The benchmark's definition: ``BENCHMARK.json`` against the contract's
limits, every name found as a file, and the import rules of the
harness. CPU only, no program run."""

import ast
import json
import re
from pathlib import Path

import pytest

from perfbench.harness.find import Finder

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRIC_KEYS = {"name", "unit", "better", "source"}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert SPEC["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys_use_the_allowed_characters():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        names += [w["name"], w["config"], w["traffic"]]
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names), names
    for items in ("configs", "workloads"):
        entries = [e["name"] for e in SPEC[items]]
        assert len(entries) == len(set(entries))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for text in ([c["why"] for c in SPEC["configs"]]
                 + [w["why"] for w in SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    def applies(m, w):
        return "workloads" not in m or w in m["workloads"]

    for w in (w["name"] for w in SPEC["workloads"]):
        e2e = {m["name"] for m in SPEC["end_to_end"] if applies(m, w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in SPEC["per_layer"] if applies(m, w)]
        assert layers
        assert all(m["moves"] in e2e for m in layers)


def test_every_name_is_found_as_a_file():
    find = Finder()
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        find.module("reference", cfg["reference"])
    for w in SPEC["workloads"]:
        find.json("configs", w["config"])
        mix = find.json("traffic", w["traffic"])
        find.module("clients", mix["client"])
    for m in SPEC["end_to_end"]:
        assert callable(find.module("metrics", m["name"]).read)
    for m in SPEC["per_layer"]:
        assert callable(find.module("layers", m["name"]).read)


def test_a_file_from_another_root_is_found_first(tmp_path):
    (tmp_path / "layers").mkdir()
    (tmp_path / "layers" / "extra_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    (tmp_path / "traffic").mkdir()
    (tmp_path / "traffic" / "forward_k10.json").write_text(
        json.dumps({"client": "forward", "batch": 8}))
    find = Finder([tmp_path])
    assert find.module("layers", "extra_metric").read(None) == 42.0
    assert find.json("traffic", "forward_k10")["batch"] == 8
    with pytest.raises(FileNotFoundError):
        find.module("layers", "no_such_metric")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_harness_module_imports_jax_or_the_jax_package():
    files = list((ROOT / "perfbench").rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "repro"}, f


def test_the_reference_imports_nothing_of_the_program():
    for f in (ROOT / "perfbench" / "reference").glob("*.py"):
        assert not _imports(f) & {"repro_torch", "repro", "jax"}, f


def test_the_forbidden_module_check_compares_whole_top_level_names():
    from perfbench import run
    loaded = ["torch", "repro_torch", "repro_torch.core.sah", "jaxtyping",
              "reprox"]
    assert run.forbidden_modules(loaded) == []
    assert run.forbidden_modules(loaded + ["repro.core", "jax.numpy"]) == [
        "jax", "repro"]

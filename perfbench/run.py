"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by the names ``BENCHMARK.json`` gives
(``harness/find.py``). The run makes its data from the seed, builds the
index and warms the cell's own shapes (set-up), drives the mix in a
closed loop until ``--seconds`` have passed (the window), then judges
what the window produced against the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``, each number compared
beside its limit; the same checks end standard error.

It exits with 2 and prints no result where there is no CUDA device or
fewer than the cell asks for, and with 3 where the process has loaded
JAX, jaxlib, flax or the JAX package (``repro``) once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths() -> None:
    """The program (``src``) and the harness importable. The program
    builds its kernels into ``build/torch_kernels/`` of the checkout
    (``repro_torch/kernels/_build.py``), so only a checkout's first run
    builds them."""
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (``names``, by default ``sys.modules``) whose
    top-level name is JAX's, jaxlib's, flax's or the JAX package's,
    compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({name.split(".", 1)[0] for name in names}
                  & set(FORBIDDEN))


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def device_info(device, chips: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                device))}


def load_cell(workload: str, seed: int, trace: bool, *, device: str,
              bench: Path = ROOT / "BENCHMARK.json", roots=()):
    """The spec, the cell's entry, its finder, its client module and the
    context a client's ``Cell`` takes, all found by name. ``roots`` are
    further folders searched for the cell's files before ``perfbench/``
    (tests add a tiny configuration from one)."""
    _paths()
    from perfbench.harness.find import Finder
    from perfbench.harness.trace import Recorder

    spec = json.loads(Path(bench).read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"unknown workload {workload!r}")
    find = Finder(roots)
    config = find.json("configs", cell["config"])
    mix = find.json("traffic", cell["traffic"])
    client = find.module("clients", mix["client"])
    ctx = SimpleNamespace(
        workload=workload, seed=seed, trace=trace, device=device,
        config=config, mix=mix, rec=Recorder(device),
        reference=find.module("reference", config["reference"]))
    return spec, cell, find, client, ctx


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", bench: Path = ROOT / "BENCHMARK.json",
        roots=(), t_start: float | None = None) -> dict:
    """One run of cell ``workload``; returns the result line's object."""
    spec, cell, find, client, ctx = load_cell(
        workload, seed, trace, device=device, bench=bench, roots=roots)
    import torch

    from repro_torch.kernels import ops

    t_start = T_START if t_start is None else t_start
    config, mix = ctx.config, ctx.mix
    torch.set_num_threads(min(2, torch.get_num_threads()))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    sut = client.Cell(ctx)
    sut.setup()
    ops.reset_launch_counts()
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    units = batches = 0
    while True:
        units += sut.batch()
        batches += 1
        if time.perf_counter() - t_window >= seconds and sut.may_end():
            break
    window_s = time.perf_counter() - t_window
    if trace:
        sut.profile()
    dev = device_info(device, int(cell["chips"]))
    sut.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks, failed, info = sut.check(config["limits"])

    measured = SimpleNamespace(
        unit=client.UNIT, units=units, batches=batches, window_s=window_s,
        setup_s=setup_s, rec=ctx.rec, config=config, mix=mix)
    kinds = ("per_layer", "layers") if trace else ("end_to_end", "metrics")
    metrics = {}
    for m in spec[kinds[0]]:
        if not _applies(m, workload):
            continue
        value = find.module(kinds[1], m["name"]).read(measured)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if trace:
        busy, wall = ctx.rec.session_totals()
        dev["busy_s"], dev["window_s"] = busy, wall
    limits = config["limits"]
    compared = {name: {"value": value, "limit": limits[name]}
                for name, value in checks.items()}
    out = {"correct": all(c["value"] <= c["limit"]
                          for c in compared.values()),
           "attempted": units, "failed": failed, "metrics": metrics,
           "device": dev, "info": info}
    breakdown = ctx.rec.breakdown() if trace else None
    if breakdown:
        out["breakdown"] = breakdown
    out["checks"] = compared
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    import torch
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = next((w["chips"] for w in spec["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

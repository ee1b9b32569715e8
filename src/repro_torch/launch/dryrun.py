"""Dry run of the port's cells: trace every (arch x shape) cell's step on
the meta device and reckon its memory and roofline, on one device or as
one rank of the reference's production mesh; with ``--measure``, run a
one-device cell on the card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --out results/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all      # CPU only
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch two-tower-retrieval --shape retrieval_cand --sah
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gat-cora \\
        --shape molecule --measure                                # the card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single --variant zero1

Twin of ``src/repro/launch/dryrun.py``. The reference lowers and compiles
each cell ahead of time on a mesh of fake devices and reads XLA's memory
and cost analyses. Eager PyTorch compiles nothing; in place of that
compile each cell's step runs once at full shape on the meta device,
which allocates no memory, under a ``roofline.Reckoner`` that counts its
FLOPs and the bytes it holds (PORT.md, "Launchers and cells"). Each cell
writes ``<out>/<arch>__<shape>__one.json``: the reference's record less
its XLA-only keys (``lower_s``, ``compile_s``, ``alias_bytes``,
``generated_code_bytes``), with ``trace_s`` and ``fits_one_h100``.

``--mesh single|multi|both`` reckons one rank (the first) of the
reference's production mesh, 16x16 ("data", "model") or 2x16x16 with
"pod" (``launch/mesh.py``), in this one process, on the meta device: the
cell under the mesh (``cells.build_cell(..., mesh=)``: the rank's shards
and its collectives) over a fake process group of 256 or 512 ranks
(``fake_world``: torch's ``"fake"`` backend, whose collectives return at
once and move no values, so no check on the path may decide anything on
meta tensors, ``dist/collectives.py``). The record adds the collectives'
output bytes by kind (``collectives.counting``, the reference's
output-shape proxy; ``collective_s`` takes an all-reduce twice, over the
port's NVLink rate) and writes ``<arch>__<shape>__<mesh>.json``;
``--mesh one`` (the default) is the one-device record. ``--variant``
(``zero1`` of an LM train cell, ``dst_partitioned`` of a GNN cell) is
``launch/perf.py``'s.

Without ``--measure`` nothing is allocated and no card is needed.
``--measure`` needs one: it draws the cell's inputs on the card
(``cells.materialize``) and times one step after a warm one, to a device
sync, beside the reckoned bound; a cell the reckoning says does not fit
is not run. A cell that fails to trace or run is a fault: the process
exits nonzero.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Callable

import torch

from repro_torch.dist import collectives as coll
from repro_torch.launch import cells as cells_lib
from repro_torch.launch import roofline as rl

FIT_MARGIN = 8 * 2 ** 30     # the CUDA context, cuBLAS workspaces and the
#                              caching allocator's rounding and splits
FIT_BYTES = rl.HBM_BYTES - FIT_MARGIN
FIT = "fit"                  # a cut to the largest value that fits


@dataclasses.dataclass
class CellRun:
    cell: cells_lib.Cell
    record: dict                   # what the JSON file holds
    abstract_out: Any              # the step's output on the meta device
    args: tuple | None = None      # the measured run's inputs
    out: Any = None                # the timed step's output


def reckon(cell: cells_lib.Cell) -> tuple[dict, Any]:
    """(the record's memory, roofline and trace fields, the step's meta
    output) of one traced step."""
    args = cell.abstract_args
    t0 = time.perf_counter()
    with coll.counting() as moved, rl.Reckoner(args) as r:
        out = cell.step(*args)
    trace_s = time.perf_counter() - t0
    arg_b = rl.storage_bytes(args)
    out_b = rl.storage_bytes(out)
    new_out_b = rl.storage_bytes(out, exclude=args)
    total = arg_b + r.peak_bytes
    roof = rl.from_counts(r.flops, r.bytes_read + out_b, total,
                          tensor_core_flops=r.tensor_core_flops,
                          coll_bytes=moved)
    rec = {
        "trace_s": round(trace_s, 2),
        "memory": {"temp_bytes": r.peak_bytes - new_out_b,
                   "argument_bytes": arg_b, "output_bytes": out_b,
                   "argument_bytes_read": r.bytes_read,
                   "per_device_total": total},
        "fits_one_h100": total <= FIT_BYTES,
        "fit_bytes": FIT_BYTES,
        "roofline": roof.to_dict(),
        "bound_s": roof.bound_s,
    }
    return rec, out


def fit_cut(arch_id: str, shape_name: str, cut: dict,
            resident: int = 0) -> dict:
    """``cut`` with each ``FIT`` value (of ``n_layers`` or a shape dim)
    replaced by the largest value, at most the published one, with which
    the cell fits one card beside ``resident`` bytes already held, by the
    reckoning (a bisection: the reckoned bytes grow with each)."""
    from repro_torch.configs import base as cfg_base
    arch = cfg_base.get(arch_id)
    cut = dict(cut)
    for name in [k for k, v in cut.items() if v == FIT]:
        lo = 1
        hi = (arch.make_config().n_layers if name == "n_layers"
              else arch.shape(shape_name).dims[name])
        while lo < hi:
            mid = (lo + hi + 1) // 2
            probe = {k: v for k, v in cut.items() if v != FIT}
            cell = cells_lib.build_cell(arch_id, shape_name,
                                        {**probe, name: mid})
            total = reckon(cell)[0]["memory"]["per_device_total"]
            if total + resident <= FIT_BYTES:
                lo = mid
            else:
                hi = mid - 1
        cut[name] = lo
    return cut


def same_layout(got, want) -> bool:
    """True when two outputs hold tensors of equal shapes and dtypes, in
    the same order (``roofline.tensors_of``)."""
    a, b = rl.tensors_of(got), rl.tensors_of(want)
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(a, b))


def _sync_ms(fn) -> tuple[Any, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def measure(cell: cells_lib.Cell, seed: int,
            on_args: Callable | None = None) -> tuple[dict, tuple, Any]:
    """Run ``cell`` on the card: its inputs from a CUDA generator seeded
    ``seed``, ``on_args(args)`` (a caller's check on the inputs, before
    any step), one warm step, then one timed step. Returns (the record's
    ``measured`` fields, the inputs, the timed step's output). The peak
    is the cell's own: what the process held before the inputs were
    drawn (``resident_bytes``) is left out."""
    if not torch.cuda.is_available():
        raise RuntimeError("--measure runs a cell on the card, and there is "
                           "no CUDA device")
    dev = torch.device("cuda")
    resident = torch.cuda.memory_allocated()
    gen = torch.Generator(device=dev).manual_seed(seed)
    args = cells_lib.materialize(cell, dev, gen)
    if on_args is not None:
        on_args(args)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    warm, warm_ms = _sync_ms(lambda: cell.step(*args))
    first_loss = (float(warm[1]["loss"]) if cell.kind == "train" else None)
    del warm
    # the warm step's cached blocks, split to its sizes, would crowd the
    # timed step of a cell near the card's size (a GAT step at 72 GiB)
    torch.cuda.empty_cache()
    out, ms = _sync_ms(lambda: cell.step(*args))
    rec = {"device": torch.cuda.get_device_name(0), "step_ms": ms,
           "warm_step_ms": warm_ms,
           "peak_bytes": torch.cuda.max_memory_allocated() - resident,
           "resident_bytes": resident,
           "first_loss": first_loss}
    return rec, args, out


MESHES = ("single", "multi")


@contextlib.contextmanager
def fake_world(kind: str, rank: int = 0):
    """Rank ``rank`` of the production mesh ``kind`` ("single": 16x16,
    "multi": 2x16x16) over a fake process group in this process: yields
    the ``DeviceMesh``, and destroys the group on exit. For meta tensors
    only (its collectives move no values). Raises if this process has a
    process group already."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as mesh_lib
    if dist.is_initialized():
        raise RuntimeError("the mesh dry run makes a fake world of its own; "
                           "this process has a process group already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=512 if kind == "multi" else 256)
    try:
        yield mesh_lib.make_production_mesh(multi_pod=kind == "multi",
                                            device_type="cpu")
    finally:
        dist.destroy_process_group()


def run_cell(arch_id: str, shape_name: str, out_dir: str | None = None, *,
             sah_variant: bool = False, measure_it: bool = False,
             cut: dict | None = None, seed: int = 0,
             on_args: Callable | None = None, mesh=None,
             mesh_kind: str = "one", variant: str = "") -> CellRun:
    """Build, trace and reckon one cell (``sah_variant``: the SAH sketch
    retrieval cell), with ``cut`` (a ``FIT`` value: the largest that fits,
    ``fit_cut``); with ``measure_it``, run it on the card unless the
    reckoning says it does not fit. Under ``mesh`` (a ``fake_world``'s,
    named ``mesh_kind``) the cell is one rank's, uncut, and is not run.
    Writes the record to ``out_dir`` when given."""
    if mesh is not None and (measure_it or cut):
        raise ValueError("a mesh cell is reckoned whole, and not run")
    if sah_variant:
        from repro_torch.launch.serve import build_sah_retrieval_cell
        cell = build_sah_retrieval_cell(mesh=mesh)
        shape_name = cell.shape_name
    elif mesh is not None:
        cell = cells_lib.build_cell(arch_id, shape_name, mesh=mesh,
                                    variant=variant)
    else:
        cell = cells_lib.build_cell(arch_id, shape_name,
                                    fit_cut(arch_id, shape_name, cut or {}),
                                    variant=variant)
    reckoned, abstract_out = reckon(cell)
    flops_cut = {k: v[1] for k, v in cell.reduced.items()}
    try:
        mflops = rl.model_flops(arch_id, shape_name.replace("_sah", ""),
                                flops_cut)
    except KeyError:
        mflops = None
    n_dev = 1 if mesh is None else int(mesh.size())
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
           "n_devices": n_dev,
           "mesh_shape": {} if mesh is None else {
               name: int(mesh.size(i))
               for i, name in enumerate(mesh.mesh_dim_names)},
           "reduced": {k: list(v) for k, v in cell.reduced.items()},
           **reckoned, "model_flops_global": mflops, "note": cell.note}
    if variant:
        rec["variant"] = variant
    flops = rec["roofline"]["flops_per_dev"]
    if mflops is not None and flops > 0:
        rec["useful_flops_ratio"] = mflops / (flops * n_dev)
    run = CellRun(cell, rec, abstract_out)
    if measure_it and rec["fits_one_h100"]:
        m, run.args, run.out = measure(cell, seed, on_args)
        m["step_over_bound"] = m["step_ms"] / (rec["bound_s"] * 1e3)
        m["outputs_match_abstract"] = same_layout(run.out, abstract_out)
        rec["measured"] = m
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir,
                            f"{arch_id}__{shape_name}__{mesh_kind}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2)
    return run


def summary(rec: dict) -> str:
    """One line: memory, fit, roofline terms and, when measured, the step
    against its bound."""
    r, gib = rec["roofline"], 2 ** 30
    line = (f"mem/dev={rec['memory']['per_device_total'] / gib:.2f}GiB "
            f"fits={rec['fits_one_h100']} trace={rec['trace_s']:.1f}s "
            f"compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms ")
    if rec["n_devices"] > 1:
        line += f"coll={r['collective_s'] * 1e3:.2f}ms "
    line += f"dom={r['dominant']}"
    if rec["reduced"]:
        line += f" reduced={rec['reduced']}"
    m = rec.get("measured")
    if m is not None:
        line += (f" | step={m['step_ms']:.2f}ms "
                 f"peak={m['peak_bytes'] / gib:.2f}GiB "
                 f"step/bound={m['step_over_bound']:.2f}")
    return line


def _run_jobs(jobs, args, kind: str, mesh) -> list[str]:
    """Run the CLI's jobs on one mesh kind; returns the failed tags."""
    failures = []
    for arch_id, shape_name, sah in jobs:
        tag = (f"{arch_id} x {shape_name}" + (" [sah]" if sah else "")
               + (f" x {kind}" if kind != "one" else "")
               + (f" [{args.variant}]" if args.variant else ""))
        run = None
        try:
            run = run_cell(arch_id, shape_name, args.out, sah_variant=sah,
                           measure_it=args.measure, seed=args.seed,
                           mesh=mesh, mesh_kind=kind, variant=args.variant)
            skip = (" (not run: does not fit one H100)" if args.measure
                    and "measured" not in run.record else "")
            print(f"OK   {tag}: {summary(run.record)}{skip}", flush=True)
        except Exception as e:  # noqa: BLE001 -- report every cell
            failures.append(tag)
            print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
            traceback.print_exc()
        finally:
            run = None              # frees the measured inputs
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return failures


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--sah", action="store_true",
                    help="SAH sketch variant of two-tower retrieval_cand")
    ap.add_argument("--measure", action="store_true",
                    help="also run each cell that fits on the card")
    ap.add_argument("--mesh", choices=("one",) + MESHES + ("both",),
                    default="one",
                    help="one device, or one rank of the production mesh")
    ap.add_argument("--variant", default="",
                    choices=("", "zero1", "dst_partitioned"),
                    help="a perf variant of the cell (launch/perf.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args()
    if args.measure and args.mesh != "one":
        ap.error("--measure runs one device's cells: give --mesh one")
    if args.measure and not torch.cuda.is_available():
        print("dryrun: --measure needs a CUDA device; there is none",
              file=sys.stderr)
        return 2

    from repro_torch.configs import base as cfg_base
    jobs = []
    if args.all:
        jobs = [(a, s.name, False) for a in cfg_base.all_archs()
                for s in cfg_base.get(a).shapes]
        jobs.append(("two-tower-retrieval", "retrieval_cand", True))
    elif args.arch and args.shape:
        jobs = [(args.arch, args.shape, args.sah)]
    else:
        ap.error("give --arch and --shape, or --all")

    kinds = {"one": ("one",), "both": MESHES}.get(args.mesh, (args.mesh,))
    failures = []
    for kind in kinds:
        with (contextlib.nullcontext() if kind == "one"
              else fake_world(kind)) as mesh:
            failures += _run_jobs(jobs, args, kind, mesh)
    if failures:
        print(f"\n{len(failures)} FAILURES:\n  " + "\n  ".join(failures))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

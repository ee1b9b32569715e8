"""Perf variant runner: reckons (and with ``--measure`` runs on the card)
a variant of a chosen cell and records its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.perf --variant retrieval_sah
    PYTHONPATH=src python -m repro_torch.launch.perf --variant retrieval_sah \\
        --measure                                                 # the card
    PYTHONPATH=src python -m repro_torch.launch.perf --variant qwen3_zero1

Twin of ``src/repro/launch/perf.py``. Variants:
  retrieval_sah   two-tower retrieval_cand with the SAH sketch index
                  (``launch/serve.py::build_sah_retrieval_cell``), one
                  device
  qwen3_zero1     qwen3-0.6b train_4k, pure-DP + ZeRO-1 optimizer sharding
  gat_dstpart     gat-cora ogb_products, dst-partitioned aggregation
The last two are one rank of the 16x16 production mesh, reckoned by the
mesh dry run (``dryrun.py --mesh single --variant ...``) in a process of
its own, since its fake process group must not touch the caller's;
``--measure`` runs only the one-device variant.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# variant -> (arch, shape, the cell's variant) of a mesh variant
MESH_VARIANTS = {"qwen3_zero1": ("qwen3-0.6b", "train_4k", "zero1"),
                 "gat_dstpart": ("gat-cora", "ogb_products",
                                 "dst_partitioned")}
MESH_TIMEOUT = 1200          # seconds the mesh dry run of a variant may take


def _mesh_record(variant: str) -> dict:
    """The mesh dry run's record of a mesh variant, from a subprocess."""
    import repro_torch
    arch, shape, cell_variant = MESH_VARIANTS[variant]
    src = os.path.dirname(os.path.dirname(os.path.abspath(
        repro_torch.__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    with tempfile.TemporaryDirectory() as out:
        run = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--variant",
             cell_variant, "--out", out], capture_output=True, text=True,
            env=env, timeout=MESH_TIMEOUT)
        if run.returncode:
            raise RuntimeError(f"the mesh dry run of {variant} failed:\n"
                               f"{run.stdout}{run.stderr}")
        with open(os.path.join(out, f"{arch}__{shape}__single.json")) as f:
            return json.load(f)


def run_variant(variant: str, out_dir: str, *, measure: bool = False
                ) -> dict:
    """Reckon ``variant`` (and run it on the card with ``measure``, the
    one-device variant only); write and return its record."""
    if variant in MESH_VARIANTS:
        if measure:
            raise ValueError(f"perf variant {variant!r} is one rank of a "
                             f"mesh: it is reckoned, not run")
        record = _mesh_record(variant)
    elif variant == "retrieval_sah":
        from repro_torch.launch import dryrun
        record = dryrun.run_cell("two-tower-retrieval", "retrieval_cand",
                                 sah_variant=True,
                                 measure_it=measure).record
    else:
        raise ValueError(f"unknown perf variant {variant!r}")
    rec = {"variant": variant, "mesh": record["mesh"],
           "n_devices": record["n_devices"],
           "roofline": record["roofline"],
           "memory_per_device": record["memory"]["per_device_total"],
           "fits_one_h100": record["fits_one_h100"],
           "bound_s": record["bound_s"]}
    if "measured" in record:
        rec["measured"] = record["measured"]
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{variant}.json"), "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", required=True,
                    choices=("qwen3_zero1", "gat_dstpart", "retrieval_sah"))
    ap.add_argument("--measure", action="store_true",
                    help="also run the variant on the card")
    ap.add_argument("--out", default="results/perf")
    args = ap.parse_args()
    import torch
    if args.measure and args.variant in MESH_VARIANTS:
        ap.error(f"--measure runs the one-device variant (retrieval_sah); "
                 f"{args.variant} is reckoned on one rank of the mesh")
    if args.measure and not torch.cuda.is_available():
        print("perf: --measure needs a CUDA device; there is none",
              file=sys.stderr)
        return 2
    rec = run_variant(args.variant, args.out, measure=args.measure)
    r = rec["roofline"]
    line = (f"{args.variant}: mem/dev={rec['memory_per_device'] / 2**30:.2f}"
            f"GiB compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms "
            f"coll={r['collective_s'] * 1e3:.2f}ms dom={r['dominant']}")
    if "measured" in rec:
        m = rec["measured"]
        line += (f" | step={m['step_ms']:.3f}ms "
                 f"step/bound={m['step_over_bound']:.2f}")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Perf variant runner: reckons (and with ``--measure`` runs on the card)
a variant of a chosen cell and records its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.perf --variant retrieval_sah
    PYTHONPATH=src python -m repro_torch.launch.perf --variant retrieval_sah \\
        --measure                                                 # the card

Twin of ``src/repro/launch/perf.py``. Variants:
  retrieval_sah   two-tower retrieval_cand with the SAH sketch index
                  (``launch/serve.py::build_sah_retrieval_cell``)
  qwen3_zero1     qwen3-0.6b train_4k, pure-DP + ZeRO-1 optimizer sharding
  gat_dstpart     gat-cora ogb_products, dst-partitioned aggregation
The last two shard over a device mesh and wait for the cells half of the
port's multi-GPU slice 17 (ROADMAP.md, queue 1 item 1): asking for one
raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

MESH_VARIANTS = ("qwen3_zero1", "gat_dstpart")


def run_variant(variant: str, out_dir: str, *, measure: bool = False
                ) -> dict:
    """Reckon ``variant`` (and run it on the card with ``measure``); write
    and return its record."""
    if variant in MESH_VARIANTS:
        from repro_torch.dist.policy import CELLS_SLICE
        raise NotImplementedError(
            f"perf variant {variant!r} shards over a device mesh: it waits "
            f"for {CELLS_SLICE} (ROADMAP.md, queue 1 item 1)")
    if variant != "retrieval_sah":
        raise ValueError(f"unknown perf variant {variant!r}")
    from repro_torch.launch import dryrun
    run = dryrun.run_cell("two-tower-retrieval", "retrieval_cand",
                          sah_variant=True, measure_it=measure)
    rec = {"variant": variant, "roofline": run.record["roofline"],
           "memory_per_device": run.record["memory"]["per_device_total"],
           "bound_s": run.record["bound_s"]}
    if "measured" in run.record:
        rec["measured"] = run.record["measured"]
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

"""Read a cell's correctness numbers on the card for its control, for
sound runs of the program, or for a planted fault, over many seeds in
one process.

    python3 perfbench/tools/control.py --workload <name> --batches <b> \\
        --side control|program|<fault> --seeds <s1> <s2> ...

For each seed the cell's own client makes the catalogue and the traffic
as a run does (``Cell.prepare``), then ``b`` batches go through the
side's engine and the cell's own ``check`` judges every one of them:

  control   the plain reference computed in TF32 (inputs rounded to
            TF32's 10 mantissa bits, float32 sums: the precision below
            the configuration's float32) in the engine's place; it has
            to read over a limit on every seed
  program   the program's engine, built from the seed as a run builds it:
            the sound readings a limit is set above
  <fault>   the program's engine with a fault of ``tools/faults.py``

Prints one JSON line a seed with the numbers compared and their limits.
The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from types import SimpleNamespace

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

from perfbench import run as bench  # noqa: E402
from perfbench.tools import faults  # noqa: E402


class TF32Engine:
    """The plain reference in TF32, standing in for the program's engine
    (``query_batch`` and ``kmips``, as the clients call them)."""

    def __init__(self, items, users, tie_eps, ref):
        self.ref, self.tie_eps = ref, tie_eps
        self.items = ref.tf32(items)
        self.users_unit = ref.tf32(ref.unit_rows(users))
        self._kth = {}

    def query_batch(self, queries, k):
        if k not in self._kth:
            self._kth[k] = self.ref.kth_values(self.items, self.users_unit,
                                               k)
        return SimpleNamespace(predictions=self.ref.reverse_answers(
            self._kth[k], self.users_unit, self.ref.tf32(queries),
            self.tie_eps))

    def kmips(self, users, k):
        vals, ids = self.ref.topk(self.items, self.ref.tf32(users), k)
        return SimpleNamespace(ids=ids, values=vals, tiles_visited=0)


def read(workload: str, seed: int, side: str, batches: int, *,
         device: str = "cuda", bench_file=bench.ROOT / "BENCHMARK.json",
         roots=()):
    """(checks, failed, info, limits) of ``batches`` batches of one seed
    through ``side``'s engine, every batch judged."""
    _, _, _, client, ctx = bench.load_cell(
        workload, seed, False, device=device, bench=bench_file, roots=roots)
    sut = client.Cell(ctx)
    sut.prepare()
    if side == "control":
        sut.engine = TF32Engine(sut.items, sut.users,
                                ctx.config["engine"]["tie_eps"],
                                ctx.reference)
    else:
        sut.build()
    if hasattr(sut, "_keep"):
        sut._keep.fill_(True)           # judge every batch, not a sample
    for _ in range(batches):
        sut._run()
    sut.release()
    limits = ctx.config["limits"]
    return (*sut.check(limits), limits)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", type=int, required=True)
    ap.add_argument("--side", default="control",
                    choices=("control", "program") + faults.FAULTS)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    bench._paths()
    if args.side in faults.FAULTS:
        faults.plant(args.side)
    for seed in args.seeds:
        checks, failed, info, limits = read(
            args.workload, seed, args.side, args.batches,
            device=args.device)
        print(json.dumps({
            "workload": args.workload, "seed": seed, "side": args.side,
            "batches": args.batches, "failed": failed, "info": info,
            "checks": {n: {"value": v, "limit": limits[n]}
                       for n, v in checks.items()}}), flush=True)


if __name__ == "__main__":
    main()

"""The rank bodies of the gloo worlds that tests/test_torch_smoke.py runs
through ``chip_smoke.spawn_worlds`` on the CPU.

Each body is ``fn(rank, workdir, *args)``, as ``spawn_worlds`` calls it,
and writes its record to ``rank<r>.json`` in ``workdir``. JAX-free, and
light to import: every spawned rank imports this module afresh.
"""

from __future__ import annotations

import datetime
import json
import os
import time

WAIT = 60        # seconds a rank waits for the others to be alive


def _arrive(meeting: str, rank_id: str, expected: int) -> None:
    """Mark this rank alive in ``meeting``, then wait until ``expected``
    ranks are: passes only if that many ranks live at once."""
    with open(os.path.join(meeting, f"{rank_id}.pid"), "w") as fh:
        fh.write(str(os.getpid()))
    end = time.monotonic() + WAIT
    while len([f for f in os.listdir(meeting) if f.endswith(".pid")]) \
            < expected:
        if time.monotonic() > end:
            raise TimeoutError(f"{rank_id}: the other ranks never arrived")
        time.sleep(0.05)


def allreduce_rank(rank: int, workdir: str, world: int, meeting: str | None,
                   expected: int) -> None:
    """Meet the ``expected`` ranks of every world (none if ``meeting`` is
    None), then sum rank + 1 over a gloo world of ``world`` ranks."""
    import torch
    import torch.distributed as dist
    t_start = time.time()
    if meeting is not None:
        _arrive(meeting, f"{os.path.basename(workdir)}-{rank}", expected)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=WAIT))
    try:
        x = torch.tensor([rank + 1.0])
        dist.all_reduce(x)
        record = {"rank": rank, "sum": float(x), "pid": os.getpid(),
                  "threads": torch.get_num_threads(), "t_start": t_start,
                  "t_end": time.time()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(record, fh)


def failing_rank(rank: int, workdir: str, meeting: str, expected: int,
                 fails: bool) -> None:
    """Meet the ``expected`` ranks of every world, then raise if ``fails``
    and this is rank 1; any other rank sleeps far past the test."""
    _arrive(meeting, f"{os.path.basename(workdir)}-{rank}", expected)
    if fails and rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(600)

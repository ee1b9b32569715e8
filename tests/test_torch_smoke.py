"""The smoke's schedule of gloo worlds (``chip_smoke.spawn_worlds``) and its
memory reckoning (``chip_smoke.reckon``), on the CPU.

The smoke runs its model-parallel and mesh worlds side by side on one
card. These tests hold the helper to what that needs: worlds that fit the
memory budget together are alive at once and each returns its ranks'
records, a world that does not fit beside them starts once one has
ended, a failing rank fails the call naming its world and leaves no rank
of any world alive, and a world past the budget even alone starts
nothing. The rank bodies are in
``tests/torch_smoke_worker.py``.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as S  # noqa: E402
import torch_smoke_worker as W  # noqa: E402

GIB = S.GIB


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def test_worlds_run_side_by_side_and_return_their_records(tmp_path):
    meeting = tmp_path / "meeting"
    meeting.mkdir()
    root = tmp_path / "worlds"
    root.mkdir()
    # a and b fit the budget together; c fits only once one has ended
    worlds = [S.World("a", W.allreduce_rank, 2, (2, str(meeting), 5),
                      peak=GIB),
              S.World("b", W.allreduce_rank, 3, (3, str(meeting), 5),
                      peak=GIB),
              S.World("c", W.allreduce_rank, 2, (2, None, 0), peak=GIB)]
    out = S.spawn_worlds(worlds, str(root), held=GIB, context=0,
                         budget=6 * GIB)
    assert sorted(out) == ["a", "b", "c"]
    for name, n in (("a", 2), ("b", 3), ("c", 2)):
        ranks = out[name]["ranks"]
        assert [r["rank"] for r in ranks] == list(range(n))
        assert all(r["sum"] == n * (n + 1) / 2 for r in ranks)
        assert out[name]["s"] > 0
    # a and b met (all 5 ranks alive at once), sharing the cores
    cores = len(os.sched_getaffinity(0))
    assert {r["threads"] for w in "ab" for r in out[w]["ranks"]} == {
        max(1, cores // 5)}
    # c started once a or b had ended
    assert min(r["t_start"] for r in out["c"]["ranks"]) >= min(
        r["t_end"] for w in "ab" for r in out[w]["ranks"])
    assert not any(_alive(r["pid"]) for w in out.values()
                   for r in w["ranks"])


def test_a_failing_rank_fails_the_call_and_ends_every_world(tmp_path):
    meeting = tmp_path / "meeting"
    meeting.mkdir()
    root = tmp_path / "worlds"
    root.mkdir()
    worlds = [S.World("a", W.failing_rank, 2, (str(meeting), 5, False)),
              S.World("b", W.failing_rank, 3, (str(meeting), 5, True)),
              S.World("c", W.failing_rank, 2, (str(meeting), 5, False),
                      peak=GIB)]
    t0 = time.monotonic()
    with pytest.raises(SystemExit,
                       match=r"(?s)world b: .*rank 1 fails on purpose"):
        S.spawn_worlds(worlds, str(root), held=0, context=GIB // 4,
                       budget=3 * GIB)
    assert time.monotonic() - t0 < 120
    pids = [int((meeting / f).read_text()) for f in os.listdir(meeting)]
    assert len(pids) == 5              # c, waiting for room, never started
    assert not any(_alive(p) for p in pids)


def test_the_reckoning_sums_peaks_contexts_and_the_parent():
    worlds = [S.World("x", None, 4, peak=8 * GIB),
              S.World("y", None, 2, peak=15 * GIB)]
    assert S.reckon(worlds, held=2 * GIB, context=GIB) == (
        2 * GIB + 4 * 9 * GIB + 2 * 16 * GIB)
    line = S.reckoning_line(worlds[0], worlds[1:], 2 * GIB, GIB, 72 * GIB)
    assert "70.00 GiB of a budget of 72.00 GiB" in line


def test_a_world_over_the_budget_alone_starts_nothing(tmp_path):
    worlds = [S.World("a", W.allreduce_rank, 2, (2, None, 0), peak=GIB),
              S.World("b", W.allreduce_rank, 3, (3, None, 0), peak=2 * GIB)]
    with pytest.raises(SystemExit, match="'b'.*past the budget even alone"):
        S.spawn_worlds(worlds, str(tmp_path), held=0, context=0,
                       budget=4 * GIB)
    assert os.listdir(tmp_path) == []

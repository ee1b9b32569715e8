"""Spans, counters and profiler sessions that the traced run records
from the benchmark's side, around the calls into the program's layers.

A ``Recorder`` holds everything in memory until the run ends. Spans are
host-clock intervals that start and end at a device sync, so a span's
length is the layer's time to the end of its device work. A profiler
session records device activity only (recording every host operator as
well made a reverse batch's profile take minutes).
"""

from __future__ import annotations

import time
from contextlib import contextmanager

import torch

from perfbench.roofline import busy as _busy


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """One profiler session's readings: its label, its wall seconds from
    a device sync to a device sync, and its device events (empty where
    the profiler recorded none)."""

    def __init__(self, label: str, wall_s: float,
                 events: list[_busy.DeviceEvent]):
        self.label = label
        self.wall_s = wall_s
        self.events = events

    @property
    def busy_s(self) -> float | None:
        return _busy.busy_seconds(self.events) if self.events else None


class Recorder:
    """Spans by name, counters by name and profiler sessions of one run."""

    def __init__(self, device):
        self.device = device
        self.spans: dict[str, list[float]] = {}
        self.counters: dict[str, float] = {}
        self.sessions: list[Session] = []

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    @contextmanager
    def span(self, name: str):
        sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    @contextmanager
    def profiled(self, label: str):
        """Record device activity over the block as one session (on a
        CPU device, only its wall time: there is no device activity)."""
        on_card = torch.device(self.device).type == "cuda"
        prof = (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
            if on_card else None)
        sync(self.device)
        if prof:
            prof.start()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            wall = time.perf_counter() - t0
            events = []
            if prof:
                prof.stop()
                events = [_busy.DeviceEvent(ev.name, ev.time_range.start,
                                            ev.time_range.end)
                          for ev in prof.events()
                          if ev.device_type == torch.autograd.DeviceType.CUDA
                          and ev.time_range.end > ev.time_range.start]
            self.sessions.append(Session(label, wall, events))

    def warm_profiler(self) -> None:
        """Start and stop one profiler session around a small device op
        and drop it, so the profiler's own start-up is paid in set-up and
        no measured session misses its first events."""
        with self.profiled("warm"):
            torch.ones(1024, device=self.device).sum()
        self.sessions.pop()

    def session_totals(self, prefix: str = ""):
        """(busy seconds, wall seconds) over the sessions whose label
        starts with ``prefix``. A session whose block launched nothing on
        the device (an execute left no lane to scan) records no events and
        adds its wall time alone; busy is None where no session recorded
        any."""
        chosen = [s for s in self.sessions if s.label.startswith(prefix)]
        busy = [s.busy_s for s in chosen if s.busy_s is not None]
        return (sum(busy) if busy else None), sum(s.wall_s for s in chosen)

    def breakdown(self) -> dict | None:
        events = [ev for s in self.sessions for ev in s.events]
        if not events:
            return None
        gaps = sorted((g for s in self.sessions
                       for g in _busy.idle_gaps(s.events, s.label)),
                      key=lambda g: -g[1])[:10]
        return {"device_ops": _busy.top_ops(events), "idle_gaps": gaps}

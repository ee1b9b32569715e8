"""The device's busy share from a profiler trace.

The share is the arithmetic of ``chip_smoke.py::device_profile`` at
commit d661408c4aff9ee95f174176b18a29a680cbdd15, copied so that a later
change to the smoke cannot move the yardstick: record device activity
only, take the kernel rows' device time as busy, and divide by the wall
time of the recorded window. One change: busy time is the union of the
device events' intervals rather than the sum of their durations, so
work that overlaps (a copy beside a kernel) is counted once and busy
never exceeds the window.
"""

from __future__ import annotations

from typing import NamedTuple


class DeviceEvent(NamedTuple):
    """One device activity of a trace: its name and its start and end in
    microseconds on the trace's clock."""

    name: str
    start_us: float
    end_us: float


def busy_intervals(events: list[DeviceEvent]) -> list[tuple[float, float,
                                                            str]]:
    """The union of the events' intervals, as (start, end, name of the
    event that ends the interval) in microseconds, in time order."""
    out: list[list] = []
    for ev in sorted(events, key=lambda e: e.start_us):
        if out and ev.start_us <= out[-1][1]:
            if ev.end_us > out[-1][1]:
                out[-1][1], out[-1][2] = ev.end_us, ev.name
        else:
            out.append([ev.start_us, ev.end_us, ev.name])
    return [tuple(iv) for iv in out]


def busy_seconds(events: list[DeviceEvent]) -> float:
    return sum(e - s for s, e, _ in busy_intervals(events)) * 1e-6


def top_ops(events: list[DeviceEvent], n: int = 10) -> list[list]:
    """[[name, seconds], ...]: the ``n`` names with the most device time,
    most first."""
    total: dict[str, float] = {}
    for ev in events:
        total[ev.name] = total.get(ev.name, 0.0) + (ev.end_us - ev.start_us)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, us * 1e-6] for name, us in ranked]


def idle_gaps(events: list[DeviceEvent], label: str,
              n: int = 10) -> list[list]:
    """[[name, seconds], ...]: the ``n`` longest gaps between busy
    intervals, each named by ``label`` (what the host was running) and
    the device activity the gap follows."""
    ivs = busy_intervals(events)
    gaps = [(ivs[i + 1][0] - ivs[i][1], ivs[i][2])
            for i in range(len(ivs) - 1)]
    gaps.sort(key=lambda g: -g[0])
    return [[f"{label} after {name[:60]}", us * 1e-6]
            for us, name in gaps[:n]]

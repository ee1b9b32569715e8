"""reverse_scan_roofline: the least time of the tile scan's work in the
profiled batches' execute (``roofline/scan.py::reverse`` at the card's
peaks) over the device's busy time in that execute, in percent. Nothing
where the profiler recorded no device time or the batches walked no
tile."""

from perfbench.roofline import peaks, scan


def read(run):
    c = run.rec.counters
    if run.unit != "queries" or not c.get("profile.tile_steps"):
        return None
    busy, _ = run.rec.session_totals("execute")
    if not busy:
        return None
    e = run.config["engine"]
    work = scan.reverse(chunks=c["profile.chunks"],
                        tile_steps=c["profile.tile_steps"],
                        chunk=e["chunk"], tile=e["tile"],
                        n_bits=e["n_bits"], n_cand=e["n_cand"],
                        d=run.config["d"])
    return 100.0 * peaks.least_seconds(work)[0] / busy

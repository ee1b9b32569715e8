"""forward_scan_roofline: the least time of the forward tile walks'
work in the profiled batches (``roofline/scan.py::forward`` at the
card's peaks) over the device's busy time in them, in percent. Nothing
where the profiler recorded no device time."""

from perfbench.roofline import peaks, scan


def read(run):
    c = run.rec.counters
    if run.unit != "users" or "profile.tile_steps" not in c:
        return None
    busy, _ = run.rec.session_totals("kmips")
    if not busy:
        return None
    e, b = run.config["engine"], int(c["profile.batches"])
    work = scan.forward(batches=b, queries=int(c["profile.queries"]) // b,
                        tile_steps=int(c["profile.tile_steps"]),
                        tile=e["tile"], n_bits=e["n_bits"],
                        n_cand=e["n_cand"], d=run.config["d"],
                        k=int(run.mix["k"]))
    return 100.0 * peaks.least_seconds(work)[0] / busy

"""device_idle_share.reverse: 1 - device busy / wall over the profiled
reverse batch (its plan and execute sessions; ``torch.profiler``, device
activity only), in percent. Nothing where the profiler recorded no
device time."""


def read(run):
    if run.unit != "queries":
        return None
    busy, wall = run.rec.session_totals()
    if not busy or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)

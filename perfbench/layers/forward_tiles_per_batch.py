"""forward_tiles_per_batch: tiles the forward walk visited
(``KMIPSResult.tiles_visited``) over the window's batches."""


def read(run):
    c = run.rec.counters
    if run.unit != "users" or not c.get("batches"):
        return None
    return c["tiles"] / c["batches"]

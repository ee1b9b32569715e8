"""tile_steps_per_query: tile steps of the execute's walk (one
``hamming_nearest`` launch a step under the f32 scan, one ``fused_scan``
launch under int8, from ``kernels.ops.launch_counts``) over the window's
queries."""


def read(run):
    if run.unit != "queries" or "tile_steps" not in run.rec.counters:
        return None
    return run.rec.counters["tile_steps"] / run.units

"""reverse_qps: reverse queries answered over the time of the window's
whole batches."""


def read(run):
    return run.units / run.window_s if run.unit == "queries" else None

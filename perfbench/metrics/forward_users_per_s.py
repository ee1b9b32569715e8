"""forward_users_per_s: users whose top-k list was returned over the time
of the window's whole batches."""


def read(run):
    return run.units / run.window_s if run.unit == "users" else None

"""scan_lanes_per_query: lanes the plan leaves to the item scan
(``PruningFunnel.scan_lanes``, an exact count) over the window's
queries."""


def read(run):
    if run.unit != "queries" or "scan_lanes" not in run.rec.counters:
        return None
    return run.rec.counters["scan_lanes"] / run.units

"""execute_ms_per_query: the window's spans around
``core.sah.rkmips_execute``
(each from a device sync to a device sync) over its queries."""


def read(run):
    spans = run.rec.spans.get("execute")
    if not spans or run.unit != "queries":
        return None
    return sum(spans) * 1e3 / run.units

"""index_build_s: ``RkMIPSEngine.build_seconds`` of the set-up's build
(the engine's own clock, to a device sync)."""


def read(run):
    return run.rec.counters.get("build_seconds")

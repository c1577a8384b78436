"""Host flag reads per relax sweep in the engine's fixpoints, from the
program's own counters (``repro_torch.runtime.trace``, on while the
profiler runs, so over the profiled segment of a ``--trace 1`` run):
``engine.rounds`` (the blocking ``_live_flags`` reads) over
``engine.sweeps`` (each fixpoint's most lane iterations). At
``fused_k=1`` it is 1 + fixpoints / sweeps; fused chunks or a loop kept
on the device bring it under 1. None where the program records no such
counters."""


def read(records):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    counts = trace.totals()["counts"]
    rounds = counts.get("engine.rounds", 0)
    sweeps = counts.get("engine.sweeps", 0)
    if not rounds or not sweeps:
        return None
    return rounds / sweeps

"""The share of the relax rounds the engine's fixpoints launched in which
no lane ran, from the program's own counters (``repro_torch.runtime.
trace``, on while the profiler runs, so over the profiled segment of a
``--trace 1`` run): ``engine.launched_sweeps`` (each chunk's length,
added once a loop round) less ``engine.sweeps`` (each fixpoint's most
lane iterations), over ``engine.launched_sweeps``. Such a round costs its
launches and no pass over the lanes' state; the share shows how far the
engine's chunks overshoot the sweeps a fixpoint needs. None where the
program records no such counter."""


def read(records):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    counts = trace.totals()["counts"]
    launched = counts.get("engine.launched_sweeps", 0)
    if not launched:
        return None
    return 100.0 * (launched - counts.get("engine.sweeps", 0)) / launched

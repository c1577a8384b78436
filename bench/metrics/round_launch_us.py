"""Host microseconds one round of the engine's fixpoint loop spends
enqueuing its chunks: the self time of the program's ``engine.launch``
span (``repro_torch.runtime.trace``: the cap, ``relax_sweep_fused``, the
state and flag tensor ops, from the end of one flag read to the start of
the next) over its count, over the profiled segment of a ``--trace 1``
run. Read under ``torch.profiler``, so it includes the profiler's cost
per operation, as the breakdown's idle gaps do. None where the program
records no such span."""


def read(records):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    launch = trace.totals()["spans"].get("engine.launch")
    if not launch or not launch["count"] or launch["self_s"] <= 0:
        return None
    return 1e6 * launch["self_s"] / launch["count"]

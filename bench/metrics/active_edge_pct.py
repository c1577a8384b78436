"""The share of the relax sweeps' edges that were on a frontier, from
the program's own counters (``repro_torch.runtime.trace``, on while the
profiler runs, so over the profiled segment of a ``--trace 1`` run):
``engine.active_edges`` (the fixpoints' frontier-masked relaxations, the
engine's ``edge_work`` without the seed's) over
``engine.attempted_edges`` (each lane's real edges times the sweeps it
ran: what a sweep over every edge would relax). The rest is work an
unmasked sweep would waste. None where the program records no such
counters."""


def read(records):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    counts = trace.totals()["counts"]
    active = counts.get("engine.active_edges", 0)
    attempted = counts.get("engine.attempted_edges", 0)
    if not active or not attempted:
        return None
    return 100.0 * active / attempted

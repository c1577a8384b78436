"""The share of the relax kernel's in-place finish entries that it
visited, from the program's own counters (``repro_torch.runtime.trace``,
on while the profiler runs, so over the profiled segment of a ``--trace
1`` run): ``relax.finish_visited`` (the entries of running lanes that
the finish passes after a chunk's first round read, those the round's
scatter marked or its frontier held) over ``relax.finish_entries`` (the
entries a dense pass would have read in the same rounds: the running
lanes' vertices). The rest is state the finish no longer touches. None
where the program records neither counter."""


def read(records):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    counts = trace.totals()["counts"]
    entries = counts.get("relax.finish_entries", 0)
    if not entries:
        return None
    return 100.0 * counts.get("relax.finish_visited", 0) / entries

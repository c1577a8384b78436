"""Host microseconds one round of the engine's fixpoint loop takes: the
self times of the program's ``engine.launch`` span (the round's enqueue)
and ``engine.flag_read`` span (``_live_flags``, the host's one blocking
read, which waits for the round's chunks to finish on the card), over
the ``engine.rounds`` counter (``repro_torch.runtime.trace``), over the
profiled segment of a ``--trace 1`` run. Where the card finishes a
round after its enqueue, a cheaper enqueue lengthens the wait by what it
saves: the sum is the round's host time, and falls only where the round
does. Read under ``torch.profiler``,
so it includes the profiler's cost per operation, as the breakdown's
idle gaps do. None where the program records no such spans."""


def read(records):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    got = trace.totals()
    rounds = got["counts"].get("engine.rounds", 0)
    spans = [got["spans"].get(name)
             for name in ("engine.launch", "engine.flag_read")]
    if not rounds or not all(s and s["count"] for s in spans):
        return None
    host_s = sum(s["self_s"] for s in spans)
    if host_s <= 0:
        return None
    return 1e6 * host_s / rounds

"""Device milliseconds per step of the CommonGraph cell spent moving lane
state between shards, from the program's own device span
(``repro_torch.runtime.trace``, on while the profiler runs, so over the
profiled segment of a ``--trace 1`` run): ``shard.broadcast_device_ns``
(the placed step's copies of the common graph's fixpoint row from the
first card to the others, timed by CUDA events on the first card's
stream, which runs them; on the CPU, by the host clock) over the count
of ``cell.step`` spans. None where the program records no such span."""


def read(records):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    got = trace.totals()
    ns = got["counts"].get("shard.broadcast_device_ns")
    step = got["spans"].get("cell.step")
    if not ns or not step or not step["count"]:
        return None
    return ns / 1e6 / step["count"]

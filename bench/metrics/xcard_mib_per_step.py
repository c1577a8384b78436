"""MiB copied from one shard's device to another's per step of the
CommonGraph cell, from the program's own counters
(``repro_torch.runtime.trace``, on while the profiler runs, so over the
profiled segment of a ``--trace 1`` run): ``shard.copied_bytes`` (the
placed step's broadcast of the common graph's fixpoint row to each
shard after the first, and the fixpoint loop's per-shard flags) over
the count of ``cell.step`` spans. Counted by shard index, so four slices
of one card count as four cards. None where the program records no such
counter."""


def read(records):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    got = trace.totals()
    copied = got["counts"].get("shard.copied_bytes")
    step = got["spans"].get("cell.step")
    if copied is None or not step or not step["count"]:
        return None
    return copied / 2**20 / step["count"]

"""The share of the shards' rounds in the lane-sharded hop's fixpoint
loop in which a shard sat out, all its lanes stopped while another shard
still ran, from the program's own counters
(``repro_torch.runtime.trace``, on while the profiler runs, so over the
profiled segment of a ``--trace 1`` run): 100 x
``engine.idle_shard_rounds`` over ``engine.shard_rounds`` (each round's
shards, in calls of more than one shard). A round lasts as long as its
slowest shard, so a shard that sits out waits on another card for the
whole round. It covers the hop alone: the common graph's fixpoint, one
shard on the first card while the others wait, counts in neither. None
where the program records no such counter."""


def read(records):
    try:
        from repro_torch.runtime import trace
    except ImportError:
        return None
    counts = trace.totals()["counts"]
    rounds = counts.get("engine.shard_rounds", 0)
    if not rounds:
        return None
    return 100.0 * counts.get("engine.idle_shard_rounds", 0) / rounds

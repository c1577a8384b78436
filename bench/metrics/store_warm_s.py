"""Host seconds of the snapshot store's set algebra, block building and
plan: from the store's construction to the end of the warm-up queries,
less as many steady queries (the window's median). The warm-up's own
``base_stats`` and ``hop_stats`` are not subtracted: on a cold store they
hold the window intersections and Δ blocks the executors build."""

import statistics


def read(records):
    warm, queries = records["warm"], records["queries"]
    if not queries:
        return None
    steady = statistics.median(q["wall_s"] for q in queries)
    return records["port_setup_s"] + sum(q["wall_s"] - steady for q in warm)

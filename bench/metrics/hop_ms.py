"""Mean host milliseconds per query of the addition-only hops from the
common graph's state to every snapshot: the program's ``hop_stats``
summed, or the driver's span around the cell's step, each closed by a
host sync."""


def read(records):
    queries = records["queries"]
    if not queries:
        return None
    return 1e3 * sum(q["hop_s"] for q in queries) / len(queries)

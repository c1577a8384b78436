"""Mean host milliseconds of the common graph's fixpoint per query
(``engine.run_to_fixpoint``): the program's ``base_stats`` or the
driver's span around the call, each closed by a host sync."""


def read(records):
    queries = records["queries"]
    if not queries:
        return None
    return 1e3 * sum(q["fixpoint_s"] for q in queries) / len(queries)

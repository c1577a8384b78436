"""The whole query's share of the card's memory rate: the least bytes a
query's inputs and answers need (``Inputs.min_query_bytes``: every edge
of the common graph and of each Δ read once, every answer written once)
over the published rate, against the mean query time of the traced
window. It bounds a gain whatever implements the query."""


def read(records):
    queries = records["queries"]
    rate = records.get("hbm_bytes_per_s")
    if not queries or not rate:
        return None
    mean_s = sum(q["wall_s"] for q in queries) / len(queries)
    return 100.0 * records["min_query_bytes"] / rate / mean_s

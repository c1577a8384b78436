"""Mean relax sweeps per query, as the program counts them: the
fixpoint's iterations plus each hop level's most (a count, not a time)."""


def read(records):
    queries = records["queries"]
    if not queries:
        return None
    return sum(q["sweeps"] for q in queries) / len(queries)

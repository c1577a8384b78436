"""Seconds from the first line of ``bench/run.py`` to the first timed
query: imports, input generation, the program's set-up (block building,
the store's set algebra, the plan) and the warm-up queries."""


def read(records):
    return records["setup_s"]

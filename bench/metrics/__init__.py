"""Metrics: one module per metric, ``bench/metrics/<name>.py``, named as
in ``BENCHMARK.json``'s ``end_to_end`` and ``per_layer``. Each has
``read(records)`` over the run's records (see ``bench/run.py`` ``run``)
and returns the metric's value, or None where it finds nothing to read;
the harness then leaves the metric out of the result.
"""

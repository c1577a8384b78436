"""The one traffic generator: it reads a mix's parameters from
``bench/traffic/<name>.json`` and gives the run its queries' sources.

Keys of a mix:

* ``loop``: ``"closed"`` — one client sends its next query when the last
  one has been answered (the only loop so far);
* ``clients``: 1;
* ``pool``: how many sources the mix asks from: a uniform draw, without
  repeats, among the common graph's vertices with out-degree at least 1
  (``Inputs.common_graph``, the edges every snapshot holds; the way
  Graph500 picks its search keys; counted on the run's device), made from the configuration's graph
  seed and not the run's, so that every run's window does the same set
  of work;
* ``executor``: the program's entry path, read by the driver.

Every query is single-source shortest paths, answered on every snapshot.
The run's ``--seed`` draws the order: the loop goes through the pool in a
seeded permutation, a new one each round. None of the program's query
paths keeps anything by source, so a source asked again costs what it did
the first time. The warm-up query comes from a stream of its own, so the
measured queries are the same with or without it.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.inputs import on_device


class ClosedLoop:
    """A closed loop of one client over a fixed pool of sources."""

    def __init__(self, mix: dict, inputs, seed: int, pool_seed: int,
                 device):
        if mix.get("loop") != "closed" or int(mix.get("clients", 1)) != 1:
            raise ValueError(f"traffic {mix.get('name')!r}: only a closed "
                             "loop of one client is generated")
        out_degree = torch.bincount(
            on_device(inputs.common_graph[0], device),
            minlength=inputs.num_nodes)
        sources = out_degree.nonzero().squeeze(1).cpu().numpy()
        if sources.size == 0:
            raise ValueError("the common graph has no vertex with an "
                             "out-edge")
        pool = np.random.default_rng([pool_seed, 3]).choice(
            sources, size=min(int(mix["pool"]), sources.size), replace=False)
        self.pool = np.sort(pool)
        self.rng = np.random.default_rng([seed, 1])
        self.warm_rng = np.random.default_rng([seed, 0])
        self.round: list[int] = []

    def warmup(self) -> int:
        """The source of the warm-up query, drawn from the pool."""
        return int(self.warm_rng.choice(self.pool))

    def next(self) -> int:
        """The next query's source."""
        if not self.round:
            self.round = self.rng.permutation(self.pool).tolist()[::-1]
        return int(self.round.pop())

"""The CommonGraph cell (``repro_torch.configs.commongraph``) answering
queries from fresh sources.

Set-up builds the common graph's block and the stacked Δ blocks with the
port's own block functions (``graph/edgeset.py`` ``make_block``,
``stack_delta_blocks``, as ``commongraph_edges`` does) and the cell of the
configuration's ``shape_id``. A query is ``engine.run_to_fixpoint`` over
the common graph from the source, then the cell's evolve step
(``batched_incremental`` over every lane) on that state broadcast to the
lanes, as ``commongraph_inputs`` builds it.

Configuration keys: ``shape_id`` (a key of ``COMMONGRAPH_SHAPES`` whose
sizes equal the configuration's), ``max_iters``.
"""

from __future__ import annotations

import time

import torch

from bench.drivers import Answer

EXECUTORS = ("cell",)


class Driver:
    def __init__(self, config, traffic, inputs, device, spans):
        from repro_torch.configs.commongraph import (
            COMMONGRAPH_SHAPES, make_commongraph_cell)
        from repro_torch.graph.edgeset import (
            EdgeView, lane_bucket, make_block, stack_delta_blocks)
        shape = COMMONGRAPH_SHAPES[config["shape_id"]]
        for key, value in shape.items():
            if int(config[key]) != value:
                raise ValueError(f"{config['name']}: {key} {config[key]} is "
                                 f"not the cell's {value}")
        if traffic["executor"] not in EXECUTORS:
            raise ValueError(f"{config['name']} runs executor 'cell', not "
                             f"{traffic['executor']!r}")
        n, s = shape["n_nodes"], shape["n_snapshots"]
        self.n, self.s = n, s
        self.lanes = lane_bucket(s, 1)
        self.spans = spans
        self.cell = make_commongraph_cell(config["shape_id"],
                                          max_iters=int(config["max_iters"]))
        cg, delta = inputs.data["cg"], inputs.data["delta"]
        self.cg = make_block(*cg, n, granule=shape["cg_edges"],
                             device=device)
        self.delta = stack_delta_blocks(
            [tuple(a[i] for a in delta) for i in range(s)], n,
            granule=shape["delta_edges"], num_lanes=self.lanes,
            device=device)
        self.lane_valid = torch.arange(self.lanes, device=device) < s
        self.view = EdgeView((self.cg,), n)

    def label_targets(self):
        from repro_torch.graph import engine, stability
        return [(engine, "_fixpoint_shards", "engine fixpoint loop"),
                (stability, "seed_state", "hop seed"),
                (engine, "host_sync", "host sync")]

    def query(self, source: int) -> Answer:
        from repro_torch.configs.commongraph import SEMIRING
        from repro_torch.graph.engine import host_sync, run_to_fixpoint
        t0 = time.perf_counter()
        with self.spans("fixpoint"):
            start = run_to_fixpoint(self.view, SEMIRING, source,
                                    track_parents=False)
            host_sync(start.values)
        t1 = time.perf_counter()
        with self.spans("hop"):
            values = start.values.expand(self.lanes, self.n).contiguous()
            parent = start.parent.expand(self.lanes, self.n).contiguous()
            out, _, iters, _ = self.cell.fn(values, parent, self.cg,
                                            self.delta, self.lane_valid)
            host_sync(out)
        t2 = time.perf_counter()
        sweeps = int(start.iterations) + int(iters.max())
        return Answer(out[:self.s], t1 - t0, t2 - t1, sweeps)

    def close(self):
        self.cg = self.delta = self.view = self.cell = None

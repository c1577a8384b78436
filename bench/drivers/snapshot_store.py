"""The evolve main path: the port's ``SnapshotStore`` over the benchmark's
snapshot sequence, answering queries with a batched executor.

Set-up wraps the sequence in the port's ``EvolvingSequence`` and builds a
``SnapshotStore`` on the device; executor ``wsb`` also computes
``core.trigrid.optimal_plan(store)`` once. A query is
``run_plan_batched(store, plan, SSSP, source)`` (``wsb``) or
``core.directhop.run_direct_hop_batched(store, SSSP, source)``
(``dhb``); the store's blocks are built by the warm-up query and cached.
"""

from __future__ import annotations

from bench.drivers import Answer

EXECUTORS = ("wsb", "dhb")


class Driver:
    def __init__(self, config, traffic, inputs, device, spans):
        from repro_torch.core.snapshots import SnapshotStore
        from repro_torch.core.trigrid import optimal_plan
        from repro_torch.graph.generators import EvolvingSequence
        self.executor = traffic["executor"]
        if self.executor not in EXECUTORS:
            raise ValueError(f"{config['name']}: executor "
                             f"{self.executor!r} is not one of {EXECUTORS}")
        d = inputs.data
        seq = EvolvingSequence(
            num_nodes=inputs.num_nodes,
            snapshot_keys=tuple(d["snapshot_keys"]),
            additions=tuple(d["additions"]),
            deletions=tuple(d["deletions"]))
        self.s = inputs.num_snapshots
        self.spans = spans
        self.store = SnapshotStore(seq, device=device)
        self.plan = optimal_plan(self.store) if self.executor == "wsb" \
            else None

    def label_targets(self):
        from repro_torch.core import trigrid
        from repro_torch.graph import engine, stability
        return [(trigrid, "_anchor_base", "fixpoint"),
                (trigrid, "_lane_launch", "hop launch"),
                (trigrid, "gather_lane_states", "lane gather"),
                (engine, "_fixpoint_shards", "engine fixpoint loop"),
                (stability, "seed_state", "hop seed"),
                (trigrid, "host_sync", "host sync"),
                (self.store, "delta_stack", "store lookup")]

    def query(self, source: int) -> Answer:
        from repro_torch.core.directhop import run_direct_hop_batched
        from repro_torch.core.trigrid import run_plan_batched
        from repro_torch.graph.semiring import SSSP
        if self.executor == "wsb":
            run = run_plan_batched(self.store, self.plan, SSSP, source)
            values = [run.results[i] for i in range(self.s)]
        else:
            run = run_direct_hop_batched(self.store, SSSP, source)
            values = run.results
        return Answer(values, run.base_stats.wall_s,
                      sum(h.wall_s for h in run.hop_stats),
                      run.base_stats.sweeps
                      + sum(h.sweeps for h in run.hop_stats))

    def close(self):
        self.store = self.plan = None

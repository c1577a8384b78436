"""The CommonGraph cell (``repro_torch.configs.commongraph``) lane-sharded
over a ``SnapshotMesh`` of several cards, each card's lanes kept on it,
answering queries from fresh sources.

Set-up builds the common graph's block and the stacked Δ blocks once, on
the first card, in the layout of the port's block functions
(``graph/edgeset.py`` ``make_block`` and ``stack_delta_blocks``: each row
stably sorted by destination, padded with the sentinel; the sort runs on
the card, where the host's takes seconds at this size), then places the
window (``place_window``): each card gets its contiguous lanes' Δ rows
and ``lane_valid`` slice and a copy of the common graph, which stay
there. The window has ``window_lanes(n_snapshots, cards)`` lanes, as
many a card; where the snapshots do not divide over the cards, each
card's snapshots come first in its slice and its padding lane after
them (``lane_layout``), so the cards share the snapshots evenly. A query
is ``engine.run_to_fixpoint`` over the first card's copy of the common
graph from the source, then the placed step
(``PlacedWindow.step``): the fixpoint's row broadcast to every card, each
card's lanes hopped there, nothing gathered. The query returns once
every card has synced; its answers are the lanes' rows, each on its own
card.

The mesh is cards ``0 .. cards - 1``, or, on the CPU, the CPU named
``cards`` times. ``close`` prints each card's peak allocated memory to
standard error (the harness's ``peak_mem_gib`` reads the first card's).

Configuration keys: ``n_snapshots``, ``n_nodes``, ``cg_edges``,
``delta_edges``, ``cards``, ``max_iters``.
"""

from __future__ import annotations

import sys
import time

import torch

from bench.drivers import Answer
from bench.inputs import on_device

EXECUTORS = ("cell",)
SIZES = ("n_snapshots", "n_nodes", "cg_edges", "delta_edges")


def device_block(src, dst, w, num_nodes: int, width: int, device):
    """``make_block``'s layout of host edge arrays (``[E]``, or ``[rows,
    E]`` with each row a block, as ``stack_delta_blocks`` stacks them),
    built on ``device``: each row stably sorted by ``dst`` and padded to
    ``width`` edges with sentinel edges ``(PAD_SRC, num_nodes, 0.0)``."""
    from repro_torch.graph.edgeset import PAD_SRC, EdgeBlock
    src, dst, w = (on_device(a, device) for a in (src, dst, w))
    order = torch.sort(dst, dim=-1, stable=True).indices
    src, dst, w = (t.gather(-1, order) for t in (src, dst, w))
    del order
    if width > src.shape[-1]:
        shape = (*src.shape[:-1], width - src.shape[-1])
        src, dst, w = (torch.cat([t, t.new_full(shape, v)], -1)
                       for t, v in zip((src, dst, w),
                                       (PAD_SRC, num_nodes, 0.0)))
    return EdgeBlock(src, dst, w)


def lane_layout(snapshots: int, cards: int) -> "list[int]":
    """The lane of each snapshot in a window of ``window_lanes(snapshots,
    cards)`` lanes split in contiguous slices over ``cards``: card ``d``
    holds ``snapshots // cards`` snapshots, one more for the first
    ``snapshots % cards`` cards, at the head of its slice, and a padding
    lane after them where it holds one fewer."""
    from repro_torch.configs.commongraph import window_lanes
    per = window_lanes(snapshots, cards) // cards
    counts = [snapshots // cards + (d < snapshots % cards)
              for d in range(cards)]
    return [d * per + j for d in range(cards) for j in range(counts[d])]


class Driver:
    def __init__(self, config, traffic, inputs, device, spans):
        from repro_torch.configs.commongraph import place_window, window_lanes
        from repro_torch.graph.edgeset import PAD_SRC, EdgeBlock, EdgeView
        from repro_torch.launch.mesh import make_snapshot_mesh
        if traffic["executor"] not in EXECUTORS:
            raise ValueError(f"{config['name']} runs executor 'cell', not "
                             f"{traffic['executor']!r}")
        sizes = {key: int(config[key]) for key in SIZES}
        n, s = sizes["n_nodes"], sizes["n_snapshots"]
        cards = int(config["cards"])
        devices = ([torch.device("cuda", i) for i in range(cards)]
                   if device.type == "cuda" else [device] * cards)
        self.cuda = device.type == "cuda"
        if self.cuda:
            for dev in devices[1:]:
                torch.cuda.reset_peak_memory_stats(dev)
        self.mesh = make_snapshot_mesh(devices)
        self.spans = spans
        first = self.mesh.devices[0]
        cg = device_block(*inputs.data["cg"], n, sizes["cg_edges"], first)
        rows = device_block(*inputs.data["delta"], n, sizes["delta_edges"],
                            first)
        self.lane_of = lane_layout(s, cards)
        at = torch.tensor(self.lane_of, device=first)
        lanes = window_lanes(s, cards)
        delta = EdgeBlock(*(t.new_full((lanes, t.shape[1]), v)
                            .index_copy_(0, at, t)
                            for t, v in zip(rows, (PAD_SRC, n, 0.0))))
        lane_valid = torch.zeros(lanes, dtype=torch.bool, device=first)
        lane_valid[at] = True
        self.window = place_window(sizes, self.mesh, cg, delta, lane_valid,
                                   max_iters=int(config["max_iters"]))
        del cg, rows, delta
        self.view = EdgeView(self.window.shards[0].shared_blocks, n)

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
            res = self.window.step(start.values)
            host_sync([r.values for r in res.shards])
        t2 = time.perf_counter()
        sweeps = int(start.iterations) + max(int(r.iterations.max())
                                             for r in res.shards)
        rows = res.rows()
        return Answer([rows[lane] for lane in self.lane_of], t1 - t0,
                      t2 - t1, sweeps)

    def close(self):
        if self.cuda:
            print("[bench] peak allocated GiB by card: " + ", ".join(
                f"{dev} {torch.cuda.max_memory_allocated(dev) / 2**30:.3f}"
                for dev in self.mesh.devices), file=sys.stderr)
        self.window = self.view = None

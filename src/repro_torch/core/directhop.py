"""CommonGraph Direct-Hop (paper §2, first red-arrow schedule; PyTorch port
of ``repro.core.directhop``).

Compute the query once on the CommonGraph apex, then hop *directly* to each
snapshot by streaming its missing-edge batch A_i = S_i \\ CG — additions
only, no deletions, no mutation (each snapshot's view = shared CG block +
its Δ block). The snapshots become independent, which the batched executor
exploits as one stacked snapshot (lane) axis.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.kickstarter import StreamStats
from repro_torch.core.snapshots import SnapshotStore
from repro_torch.core.trigrid import direct_hop_plan, run_plan_batched
from repro_torch.graph.engine import host_sync, incremental_additions, run_to_fixpoint
from repro_torch.graph.semiring import Semiring


@dataclasses.dataclass
class DirectHopRun:
    """Result record of a Direct-Hop run: per-snapshot values, the apex
    fixpoint's stats, per-hop stats and total wall time."""

    results: list[torch.Tensor]
    base_stats: StreamStats          # the one-off CommonGraph fixpoint
    hop_stats: list[StreamStats]     # per-snapshot addition hops
    wall_s: float
    # (valid lanes, lane_bucket) of the batched launch; empty when sequential
    lane_layout: "list[tuple[int, int]]" = dataclasses.field(
        default_factory=list)


def run_direct_hop(
    store: SnapshotStore,
    semiring: Semiring,
    source: int,
    max_iters: int = 10_000,
    cg_split: int = 1,
    track_parents: bool = False,
) -> DirectHopRun:
    """Sequential Direct-Hop (for like-for-like timing against KickStarter).

    ``cg_split`` splits the CommonGraph into src-contiguous sub-blocks.
    """
    t_all = time.perf_counter()
    n_snap = store.seq.num_snapshots
    window = (0, n_snap - 1)

    t0 = time.perf_counter()
    cg_view = (store.window_view_split(*window, cg_split) if cg_split > 1
               else store.common_graph_view(*window))
    base = run_to_fixpoint(cg_view, semiring, source, max_iters,
                           track_parents=track_parents)
    host_sync(base.values)
    base_stats = StreamStats(time.perf_counter() - t0, float(base.edge_work),
                             int(base.iterations))

    results, hop_stats = [], []
    for i in range(n_snap):
        t0 = time.perf_counter()
        delta = store.delta_block(window, (i, i))
        view = cg_view.extended(delta)       # zero-copy shared blocks
        res = incremental_additions(view, delta, semiring,
                                    base.values, base.parent, max_iters,
                                    track_parents=track_parents)
        host_sync(res.values)
        results.append(res.values)
        hop_stats.append(StreamStats(time.perf_counter() - t0,
                                     float(res.edge_work), int(res.iterations)))
    return DirectHopRun(results, base_stats, hop_stats,
                        time.perf_counter() - t_all)


def run_direct_hop_batched(
    store: SnapshotStore,
    semiring: Semiring,
    source: int,
    max_iters: int = 10_000,
    cg_split: int = 1,
    track_parents: bool = False,
    mesh=None,
) -> DirectHopRun:
    """Batched Direct-Hop: all snapshot hops as ONE stacked computation —
    the degenerate star-plan case of the level-synchronous TG executor (one
    level, one lane per snapshot); on a ``mesh`` (launch/mesh.py) the
    snapshot lanes split over its devices."""
    n_snap = store.seq.num_snapshots
    ws = run_plan_batched(store, direct_hop_plan(n=n_snap), semiring, source,
                          max_iters, cg_split=cg_split,
                          track_parents=track_parents, mesh=mesh)
    return DirectHopRun([ws.results[i] for i in range(n_snap)],
                        ws.base_stats, ws.hop_stats, ws.wall_s,
                        ws.lane_layout)

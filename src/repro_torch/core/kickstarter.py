"""KickStarter streaming baseline (Vora et al., ASPLOS'17) — deletions
included (PyTorch port of ``repro.core.kickstarter``).

Snapshots are processed *in sequence*; each transition applies a batch of
deletions (expensive: trimmed approximations) and additions (cheap:
monotone re-convergence).

Deletion trimming:
  1. *seed*: any vertex whose dependence-parent edge was deleted is tainted.
  2. *propagate*: taint flows down the dependence forest (``parent``) by
     pointer doubling in exactly ⌈log₂N⌉+1 dense rounds.
  3. *reset*: tainted vertices fall back to the identity.
  4. *re-converge*: the Δ additions are seeded with full-Δ (``"delta"``)
     seeding — the published baseline, no stable-vertex pruning — and a
     frontier-masked fixpoint over the next snapshot re-supplies trimmed
     vertices from untainted neighbors, starting from
     ``seeded.frontier | ~tainted``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from repro_torch.core.snapshots import SnapshotStore
from repro_torch.graph.edgeset import EdgeBlock, keys_to_edges, make_block, pad_edges
from repro_torch.graph.engine import (
    NO_PARENT,
    FixpointResult,
    _fixpoint,
    host_sync,
    run_to_fixpoint,
)
from repro_torch.graph.semiring import Semiring
from repro_torch.graph.stability import seed_state


def _ceil_log2(n: int) -> int:
    return max(1, int(math.ceil(math.log2(max(n, 2)))))


def _trim_and_reconverge(semiring: Semiring, num_nodes: int, max_iters: int,
                         values, parent, del_src, del_dst,
                         add_block: EdgeBlock, next_blocks):
    """One KickStarter transition: delete-trim, add-seed, re-converge.

    Returns ``(FixpointResult, tainted vertex count)``.
    """
    # 1. seed: tainted where the parent edge (parent[v] -> v) was deleted;
    # padded deletions (dst == num_nodes) hit the -2 sentinel, never a src.
    p_pad = torch.cat([parent, parent.new_tensor([-2])])
    dd = del_dst.long()
    hit = p_pad[dd] == del_src
    seed = torch.zeros(num_nodes + 1, dtype=torch.int32, device=parent.device)
    seed.scatter_reduce_(0, dd, hit.int(), reduce="amax")
    tainted = seed[:num_nodes] > 0

    # 2. propagate taint down the dependence forest (pointer doubling).
    p = parent
    for _ in range(_ceil_log2(num_nodes) + 1):
        has = p >= 0
        safe = p.clamp(min=0).long()
        tainted = tainted | (tainted[safe] & has)
        p = torch.where(has, p[safe], NO_PARENT)

    # 3. reset trimmed approximation.
    values = torch.where(tainted, semiring.identity, values)
    parent = torch.where(tainted, NO_PARENT, parent)

    # 4. seed additions (full-Δ: the published baseline), then re-converge
    # over the next snapshot's edges.
    seeded = seed_state(semiring, num_nodes, values, parent, (add_block,),
                        mode="delta")
    frontier = seeded.frontier | ~tainted
    res = _fixpoint(semiring, num_nodes, max_iters, seeded.values,
                    seeded.parent, frontier, next_blocks)
    return (FixpointResult(res.values, res.parent, res.iterations + 1,
                           res.edge_work + seeded.seed_work),
            tainted.sum())


@dataclasses.dataclass
class StreamStats:
    """Wall time and work of one step (a fixpoint or one hop/transition)."""

    wall_s: float
    edge_work: float
    sweeps: int
    tainted: int = 0
    mutate_s: float = 0.0


def run_kickstarter_stream(
    store: SnapshotStore,
    semiring: Semiring,
    source: int,
    max_iters: int = 10_000,
    include_mutation: bool = True,
) -> tuple[list[torch.Tensor], list[StreamStats]]:
    """The full baseline: S_0 from scratch, then stream batches in sequence.

    Returns per-snapshot query results and per-step stats. Graph
    "mutation" (materializing each next snapshot's edge arrays — the cost
    CommonGraph's shared representation avoids) is charged to the baseline
    when ``include_mutation``.
    """
    n = store.num_nodes
    seq = store.seq
    dev = store.device
    results: list[torch.Tensor] = []
    stats: list[StreamStats] = []

    t0 = time.perf_counter()
    view0 = store.snapshot_view(0)
    res = run_to_fixpoint(view0, semiring, source, max_iters)
    host_sync(res.values)
    stats.append(StreamStats(time.perf_counter() - t0, float(res.edge_work),
                             int(res.iterations)))
    results.append(res.values)

    values, parent = res.values, res.parent
    for t in range(seq.num_snapshots - 1):
        t0 = time.perf_counter()
        # --- mutation: KickStarter materializes S_{t+1}'s edge structure.
        if include_mutation:
            keys_next = seq.snapshot_keys[t + 1]
            s, d = keys_to_edges(keys_next, n)
            w = seq.weights_for(keys_next)
            next_block = make_block(s, d, w, n, granule=store.granule,
                                    pad_pow2=store.pad_pow2, device=dev)
        else:
            next_block = store.window_block(t + 1, t + 1)
        t_mut = time.perf_counter() - t0

        add_block = store.addition_block(t)
        dk = store.deletion_keys(t)
        ds, dd = keys_to_edges(dk, n)
        # Bucket-pad deletions exactly like edge blocks (honoring pad_pow2).
        ds, dd, _ = pad_edges(ds, dd, None, n, granule=store.granule,
                              pad_pow2=store.pad_pow2)

        res, tainted = _trim_and_reconverge(
            semiring, n, max_iters, values, parent,
            torch.from_numpy(ds).to(dev), torch.from_numpy(dd).to(dev),
            add_block, (next_block,))
        host_sync(res.values)
        wall = time.perf_counter() - t0
        values, parent = res.values, res.parent
        results.append(values)
        stats.append(StreamStats(wall, float(res.edge_work), int(res.iterations),
                                 int(tainted), t_mut))
    return results, stats

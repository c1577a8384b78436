"""Triangular Grid (TG) work-sharing scheduler (PyTorch port of
``repro.core.trigrid``; the plan DPs are host code copied verbatim).

TG node T(i,j) = common graph of snapshots i..j; apex = T(0,n−1) = the
CommonGraph; leaves = the snapshots. Descending a grid edge only *adds*
edges, and the addition volume of any hop (i,j)→(a,b) is exactly
|T(a,b)| − |T(i,j)| — so optimal work sharing over the grid is a clean
interval DP:

    cost(i,j) = 0                                  if i == j
    cost(i,j) = min_m  (|T(i,m)| − |T(i,j)|) + cost(i,m)
                     + (|T(m+1,j)| − |T(i,j)|) + cost(m+1,j)

Execution walks the plan tree: each node's state hops from its parent state
via the addition-only incremental engine; each node's edge view = parent's
view ⊕ one Δ block (immutable, shared — zero mutation). ``run_plan`` walks
it depth first; ``run_plan_batched`` runs each depth as ONE batched launch
(lane axis padded to ``lane_bucket(lanes, data_extent)``, masked trailing
lanes, and split over the devices of a ``data`` mesh when one is given:
``_shard_snapshot_axis``), with values, parents, iterations and edge work
bit-identical to the sequential walk.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.core.kickstarter import StreamStats
from repro_torch.core.snapshots import SnapshotStore
from repro_torch.graph.edgeset import EdgeBlock, EdgeView, lane_bucket
from repro_torch.graph.engine import (
    NO_PARENT,
    LaneShard,
    gather_lane_states,
    host_sync,
    incremental_additions,
    incremental_additions_batched,
    incremental_additions_sharded,
    run_to_fixpoint,
)
from repro_torch.graph.semiring import Semiring
from repro_torch.graph.stability import stable_fraction_milli
from repro_torch.runtime import trace

Window = tuple[int, int]


@dataclasses.dataclass
class PlanNode:
    """A Triangular-Grid plan-tree node: a window plus its child hops.

    Every edge of the tree is an addition-only hop T(parent) → T(child)
    (nesting guarantees Δ ≥ 0); the root is the plan's apex window.
    """

    window: Window
    children: list["PlanNode"]

    def leaves(self) -> list[Window]:
        """The plan's leaf windows in DFS order (the answered snapshots)."""
        if not self.children:
            return [self.window]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out


def hop_added_edges(store: SnapshotStore, parent: Window, child: Window) -> int:
    """Δ-edge volume of the grid hop T(parent) → T(child).

    Nested windows give nested common graphs, so the hop streams exactly
    ``|T(child)| − |T(parent)|`` addition edges — the ONE cost atom every
    Δ-volume optimizer in the repo is built from: ``optimal_plan``'s
    interval DP over hops, ``plan_added_edges`` accounting, and the
    campaign planner's DP over window partitions
    (core/window.py::optimal_campaigns).
    """
    return store.window_size(*child) - store.window_size(*parent)


def optimal_plan(store: SnapshotStore, i: int = 0, j: int | None = None,
                 cost_model=None) -> PlanNode:
    """Interval-DP plan minimizing total hop cost.

    Without ``cost_model`` a hop's price is its raw added-edge volume (the
    paper's objective). With a ``cost_model`` (any object with an integer
    ``hop_cost(added_edges)``, such as the reference's calibrated
    ``SweepCostModel``) each hop is priced by ``cost_model.hop_cost(Δ)``,
    so the DP trades hop count against Δ volume. Either way the DP is
    exact over integer prices.

    Bottom-up over interval spans (and an explicit-stack tree build), so
    neither the DP nor a maximally skewed optimal plan can hit Python's
    recursion limit on long snapshot sequences.
    """
    if j is None:
        j = store.seq.num_snapshots - 1
    size = store.window_size  # cached |T(a,b)|
    price = (cost_model.hop_cost if cost_model is not None
             else (lambda added: added))

    cost: dict[Window, int] = {(a, a): 0 for a in range(i, j + 1)}
    split: dict[Window, int] = {}
    with trace.span("plan.dp"):
        for span in range(1, j - i + 1):
            for a in range(i, j + 1 - span):
                b = a + span
                s_ab = size(a, b)
                best, arg = None, a
                for m in range(a, b):
                    c = (price(size(a, m) - s_ab) + cost[(a, m)]
                         + price(size(m + 1, b) - s_ab) + cost[(m + 1, b)])
                    if best is None or c < best:
                        best, arg = c, m
                cost[(a, b)] = best
                split[(a, b)] = arg

    root = PlanNode((i, j), [])
    stack = [root]
    while stack:
        node = stack.pop()
        a, b = node.window
        if a == b:
            continue
        m = split[(a, b)]
        node.children = [PlanNode((a, m), []), PlanNode((m + 1, b), [])]
        stack.extend(node.children)
    return root


def _resolve_last(j: int | None, n: int | None) -> int:
    if j is None:
        if n is None:
            raise ValueError("pass either j= or n=")
        j = n - 1
    return j


def bisection_plan(i: int = 0, j: int | None = None, *, n: int | None = None) -> PlanNode:
    """Balanced bisection heuristic (no size table needed)."""
    j = _resolve_last(j, n)
    def build(a: int, b: int) -> PlanNode:
        if a == b:
            return PlanNode((a, b), [])
        m = (a + b) // 2
        return PlanNode((a, b), [build(a, m), build(m + 1, b)])
    return build(i, j)


def direct_hop_plan(i: int = 0, j: int | None = None, *, n: int | None = None) -> PlanNode:
    """The paper's star schedule: every snapshot one hop from the apex."""
    j = _resolve_last(j, n)
    return PlanNode((i, j), [PlanNode((k, k), []) for k in range(i, j + 1)]) \
        if i != j else PlanNode((i, i), [])


def plan_added_edges(store: SnapshotStore, plan: PlanNode) -> int:
    """Total Δ-edge volume streamed by a plan (excludes the apex itself)."""
    total = 0
    def walk(node: PlanNode):
        nonlocal total
        for c in node.children:
            total += hop_added_edges(store, node.window, c.window)
            walk(c)
    walk(plan)
    return total


@dataclasses.dataclass
class WorkSharingRun:
    """Result record of a TG plan execution: per-snapshot values plus the
    apex fixpoint stats, per-hop stats and timing/Δ-volume/lane accounting
    the work-sharing benchmarks compare executors by."""

    results: dict[int, torch.Tensor]  # snapshot index -> values
    base_stats: StreamStats
    hop_stats: list[StreamStats]
    wall_s: float
    added_edges: int
    # (valid lanes, lane_bucket) per batched launch; empty on sequential runs
    lane_layout: "list[tuple[int, int]]" = dataclasses.field(
        default_factory=list)
    # measured stable fraction (‰) over all plan hops (padding lanes excluded)
    stable_milli: int = 0


def _anchor_view(store, window, cg_split):
    """The anchor window's edge view, split per ``cg_split``."""
    return (store.window_view_split(*window, cg_split) if cg_split > 1
            else store.common_graph_view(*window))


def _anchor_base(store, window, semiring, source, max_iters, cg_split,
                 track_parents, fused_k=None):
    """Anchor-window fixpoint shared by all executors: (view, result,
    stats); span ``fixpoint``."""
    with trace.span("fixpoint"):
        t0 = time.perf_counter()
        apex_view = _anchor_view(store, window, cg_split)
        base = run_to_fixpoint(apex_view, semiring, source, max_iters,
                               track_parents=track_parents, fused_k=fused_k)
        host_sync(base.values)
        base_stats = StreamStats(time.perf_counter() - t0,
                                 float(base.edge_work), int(base.iterations))
    return apex_view, base, base_stats


def run_plan(
    store: SnapshotStore,
    plan: PlanNode,
    semiring: Semiring,
    source: int,
    max_iters: int = 10_000,
    cg_split: int = 1,
    track_parents: bool = False,
    seed: str = "instability",
    fused_k: int | None = None,
) -> WorkSharingRun:
    """Execute a TG plan (DFS; each hop = addition-only incremental update).

    ``fused_k`` threads to the engine's fused-chunk launch option
    (bit-identical results at any value).
    """
    t_all = time.perf_counter()
    apex_view, base, base_stats = _anchor_base(
        store, plan.window, semiring, source, max_iters, cg_split,
        track_parents, fused_k)

    results: dict[int, torch.Tensor] = {}
    hop_stats: list[StreamStats] = []
    unstable_counts: list[int] = []

    def dfs(node: PlanNode, view: EdgeView, values, parent):
        if not node.children:
            results[node.window[0]] = values
            return
        for child in node.children:
            t0 = time.perf_counter()
            delta = store.delta_block(node.window, child.window)
            child_view = view.extended(delta)          # shared immutable blocks
            res = incremental_additions(child_view, delta, semiring,
                                        values, parent, max_iters,
                                        track_parents=track_parents, seed=seed,
                                        fused_k=fused_k)
            host_sync(res.values)
            hop_stats.append(StreamStats(time.perf_counter() - t0,
                                         float(res.edge_work),
                                         int(res.iterations)))
            unstable_counts.append(int(res.unstable))
            dfs(child, child_view, res.values, res.parent)

    dfs(plan, apex_view, base.values, base.parent)
    return WorkSharingRun(results, base_stats, hop_stats,
                          time.perf_counter() - t_all,
                          plan_added_edges(store, plan),
                          stable_milli=stable_fraction_milli(
                              unstable_counts, store.num_nodes))


def plan_levels(plan: PlanNode) -> list[list[tuple[int, PlanNode]]]:
    """Group plan nodes by depth: level d = [(parent lane index, node), ...].

    The parent lane index points into level d−1 (the apex is the single lane
    of level −1). All nodes at one depth are independent given their parents'
    states — the invariant the level-synchronous executor batches on.
    """
    levels: list[list[tuple[int, PlanNode]]] = []
    cur = [plan]
    while True:
        nxt = [(pi, c) for pi, node in enumerate(cur) for c in node.children]
        if not nxt:
            return levels
        levels.append(nxt)
        cur = [c for _, c in nxt]


def _shard_snapshot_axis(mesh, values, parent, blocks, lane_valid):
    """Split the lane (snapshot) axis over the mesh's ``data`` axis.

    Without a mesh the inputs come back unchanged. With one, device ``d``
    of ``D`` gets the contiguous lanes ``[d·b/D, (d+1)·b/D)`` of the
    ``b``-lane launch (``PartitionSpec("data")``'s layout): a
    :class:`LaneShard` of its values, parents, rows of each stacked block
    in ``blocks`` and its ``lane_valid`` slice, placed on
    ``mesh.devices[d]``. Callers bucket the lane axis with
    ``lane_bucket(lanes, data_extent)`` first, so a mesh launch always
    shards: a lane count that does not divide raises, and there is no
    replicated fallback. The state must lie on the mesh's first device,
    where the results are gathered.
    """
    if mesh is None:
        return values, parent, blocks, lane_valid
    extent = mesh.shape["data"]
    if values.shape[0] % extent:
        raise ValueError(
            f"lane axis of {values.shape[0]} does not divide the "
            f"{extent}-device data axis — callers must bucket "
            "lane counts with lane_bucket() before sharding")
    if mesh.devices[0] != values.device:
        raise ValueError(f"the mesh's first device {mesh.devices[0]} is not "
                         f"the state's device {values.device}: results "
                         "are gathered onto the first device")
    per = values.shape[0] // extent
    shards = []
    with trace.span("shard.split"):
        for d, dev in enumerate(mesh.devices):
            rows = slice(d * per, (d + 1) * per)
            shards.append(LaneShard(
                values[rows].to(dev), parent[rows].to(dev),
                tuple(EdgeBlock(*(a[rows].to(dev) for a in b))
                      for b in blocks),
                lane_valid[rows].to(dev)))
    return shards


def _place_snapshot_axis(mesh, blocks, lane_valid, shared_blocks=()):
    """Place a launch's lane axis on the mesh once, to stay there from
    launch to launch: device ``d`` of ``D`` gets the contiguous lanes
    ``[d·b/D, (d+1)·b/D)`` of :func:`_shard_snapshot_axis`'s layout, of
    each stacked block in ``blocks`` and of ``lane_valid`` (``b`` a
    multiple of ``D``: no bucket, since a placement keeps one shape), and
    a copy of each of ``shared_blocks``, as
    a :class:`LaneShard` without state (``values`` and ``parent`` None:
    :func:`_broadcast_lane_state` gives each launch its own). Every piece
    is copied, so the caller may free its tensors. Span ``shard.place``;
    each piece placed on a shard after the first from the first shard's
    device adds its bytes to ``shard.copied_bytes`` (counted by shard
    index, so a mesh that repeats a device counts as one of distinct
    devices)."""
    per, rest = divmod(lane_valid.shape[0], mesh.shape["data"])
    if rest:
        raise ValueError(f"{lane_valid.shape[0]} lanes do not divide over "
                         f"{mesh.shape['data']} devices")
    first = mesh.devices[0]
    shards = []
    with trace.span("shard.place"):
        for d, dev in enumerate(mesh.devices):
            def put(t, d=d, dev=dev):
                if d and t.device == first:
                    trace.count("shard.copied_bytes",
                                t.numel() * t.element_size())
                return t.to(dev, copy=True)
            rows = slice(d * per, (d + 1) * per)
            shards.append(LaneShard(
                None, None,
                tuple(EdgeBlock(*(put(a[rows]) for a in b)) for b in blocks),
                put(lane_valid[rows]),
                tuple(EdgeBlock(*(put(a) for a in b))
                      for b in shared_blocks)))
    return shards


def _broadcast_lane_state(shards, values):
    """The placed ``shards`` (:func:`_place_snapshot_axis`) with one
    launch's state: the ``[N]`` row ``values``, which lies on the first
    shard's device, copied once to each other shard's device and expanded
    there over its lanes (a view: no shard holds ``[S_d, N]`` copies of
    it, let alone the whole launch's ``[S, N]``), with a row of
    ``NO_PARENT`` made on each shard's device for parents. Span
    ``shard.broadcast``, with the device span ``shard.broadcast_device_ns``
    around the copies alone, on the first shard's device, whose stream
    runs them; each row copied to a shard after the first adds its bytes
    to ``shard.copied_bytes``."""
    first = shards[0].lane_valid.device
    if values.device != first:
        raise ValueError(f"the row lies on {values.device}, not on the "
                         f"first shard's device {first}")
    n = values.shape[-1]
    with trace.span("shard.broadcast"):
        with trace.device_span("shard.broadcast_device_ns", first):
            rows = [values.to(shard.lane_valid.device) for shard in shards]
        if len(shards) > 1:
            trace.count("shard.copied_bytes", (len(shards) - 1)
                        * values.numel() * values.element_size())
        out = []
        for shard, row in zip(shards, rows):
            lanes = shard.lane_valid.shape[0]
            parent = torch.full((n,), NO_PARENT, dtype=torch.int32,
                                device=row.device)
            out.append(shard._replace(values=row.expand(lanes, n),
                                      parent=parent.expand(lanes, n)))
    return out


def _lane_launch(store: SnapshotStore, mesh, semiring: Semiring, values,
                 parent, shared_blocks, delta_blocks, lanes: int, *,
                 max_iters: int, track_parents: bool, seed: str,
                 fused_k: int | None):
    """ONE batched launch of the executors (``run_plan_batched``'s levels,
    ``core/window.py``'s slides) over ``lanes`` valid lanes, padded to
    ``lane_bucket(lanes, data_extent)`` with masked trailing lanes. The
    frontier seeds from the last Δ group; with a mesh the lanes split over
    its devices, each shard relaxing the shared blocks' copy on its device
    (``SnapshotStore.replicas``), and the result is gathered onto the
    store's device."""
    bucket = lane_bucket(lanes, mesh.shape["data"] if mesh is not None else 1)
    if values.shape[0] != bucket:
        raise ValueError(f"{values.shape[0]} state lanes for {lanes} valid "
                         f"lanes: the launch pads to {bucket}")
    lane_valid = torch.arange(bucket, device=values.device) < lanes
    kw = dict(max_iters=max_iters, track_parents=track_parents, seed=seed,
              fused_k=fused_k)
    if mesh is None:
        return incremental_additions_batched(
            store.num_nodes, semiring, values, parent,
            shared_blocks=tuple(shared_blocks), delta_blocks=delta_blocks,
            seed_blocks=(delta_blocks[-1],), lane_valid=lane_valid, **kw)
    shards = _shard_snapshot_axis(mesh, values, parent, delta_blocks,
                                  lane_valid)
    with trace.span("shard.replicas"):
        shards = [s._replace(shared_blocks=store.replicas(shared_blocks,
                                                          s.values.device))
                  for s in shards]
    return incremental_additions_sharded(store.num_nodes, semiring, shards,
                                         **kw)


def run_plan_batched(
    store: SnapshotStore,
    plan: PlanNode,
    semiring: Semiring,
    source: int,
    max_iters: int = 10_000,
    cg_split: int = 1,
    track_parents: bool = False,
    mesh=None,
    seed: str = "instability",
    fused_k: int | None = None,
) -> WorkSharingRun:
    """Execute a TG plan level-synchronously: one batched launch per depth.

    Siblings at one depth are independent, so each level runs as ONE
    ``incremental_additions_batched`` launch: the level's Δ-batches are
    stacked on a leading lane axis (``SnapshotStore.delta_stack``) and
    parent states are gathered into the lanes. Per-lane edge views are the
    apex blocks (shared) plus two stacked groups: the lane's cumulative Δ
    from the apex to its parent and the final parent→child hop Δ, which
    alone seeds the frontier (``seed_blocks``) — matching the sequential
    seeding and its edge-work accounting. Each level's lane count pads to
    ``lane_bucket(lanes, data_extent)`` with masked trailing lanes, where
    ``data_extent`` is the ``mesh``'s (launch/mesh.py) device count or 1;
    on a mesh every level's lanes split over its devices.
    """
    t_all = time.perf_counter()
    apex_view, base, base_stats = _anchor_base(
        store, plan.window, semiring, source, max_iters, cg_split,
        track_parents, fused_k)

    results: dict[int, torch.Tensor] = {}
    hop_stats: list[StreamStats] = []
    lane_layout: list[tuple[int, int]] = []
    unstable_counts: list = []
    if not plan.children:
        results[plan.window[0]] = base.values

    apex_window = plan.window
    data_extent = mesh.shape["data"] if mesh is not None else 1
    prev_nodes = [plan]
    prev_values = base.values[None]
    prev_parent = base.parent[None]
    for level in plan_levels(plan):
        with trace.span("hop.level"):
            t0 = time.perf_counter()
            lanes = len(level)
            bucket = lane_bucket(lanes, data_extent)
            lane_layout.append((lanes, bucket))
            hop_stacked = store.delta_stack(
                [(prev_nodes[pi].window, c.window) for pi, c in level],
                num_lanes=bucket)
            if any(prev_nodes[pi].window != apex_window for pi, _ in level):
                prefix_stacked = store.delta_stack(
                    [(apex_window, prev_nodes[pi].window) for pi, _ in level],
                    num_lanes=bucket)
                delta_blocks = (prefix_stacked, hop_stacked)
            else:
                delta_blocks = (hop_stacked,)   # level 1: parents ARE the apex

            # Masked padding lanes re-run lane 0's parent state over an
            # empty Δ: no frontier is ever seeded, values stay an inert
            # copy, and lane_valid zeroes them out of the work accounting.
            lane_map = [pi for pi, _ in level] + [0] * (bucket - lanes)
            values, parent = gather_lane_states(prev_values, prev_parent,
                                                lane_map)
            res = _lane_launch(store, mesh, semiring, values, parent,
                               apex_view.blocks, delta_blocks, lanes,
                               max_iters=max_iters,
                               track_parents=track_parents, seed=seed,
                               fused_k=fused_k)
            host_sync(res.values)
            wall = time.perf_counter() - t0
            with trace.span("hop.stats"):
                hop_stats.append(StreamStats(wall,
                                             float(res.edge_work.sum()),
                                             int(res.iterations.max())))
                unstable_counts.extend(int(u) for u in res.unstable[:lanes])
            for lane, (_, c) in enumerate(level):
                if not c.children:
                    results[c.window[0]] = res.values[lane]
            prev_nodes = [c for _, c in level]
            prev_values, prev_parent = res.values, res.parent

    return WorkSharingRun(results, base_stats, hop_stats,
                          time.perf_counter() - t_all,
                          plan_added_edges(store, plan), lane_layout,
                          stable_milli=stable_fraction_milli(
                              unstable_counts, store.num_nodes))

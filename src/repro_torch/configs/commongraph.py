"""The paper's own engine at production scale, run concretely on the card.

Counterpart of ``repro.configs.commongraph``: the batched Direct-Hop step
of CommonGraph — one lane per snapshot, each lane the common graph's
fixpoint carried to its snapshot by the addition-only hop over its Δ
edges — at the two protocol scales of ``COMMONGRAPH_SHAPES``, or at
any sizes (:func:`make_window_cell`). The cell's lane axis is padded to
``lane_bucket(snapshots, extent)`` with masked lanes, so the cell shards
for any snapshot count on a mesh of any extent; a placed window's to
:func:`window_lanes`, as many a device.

The reference's cell is abstract (its dry run lowers it on a production
mesh); the port's cell has meta-device arguments of the same shapes, and
:func:`commongraph_inputs` materializes concrete ones from numpy with
the port's generators, so the step runs on one card or lane-sharded over
a ``SnapshotMesh``.

Mesh layout. The reference puts the snapshot (lane) axis over its batch
axes, ``(pod, data)`` or ``(data,)``, and the common graph's and the Δ
blocks' edges over ``model``: each chip reduces its part of the edges
and a semiring all-reduce combines the partial results. The port has no
counterpart of the ``model`` split: each lane shard holds the whole
common graph on its device (768 MiB per card at ``window_64x``) and
relaxes every edge itself. Only the lane axis is split, in one of two
ways. The cell's ``fn`` takes the whole ``[sb, n]`` state on the mesh's
first device, splits it over the devices each step
(``core/trigrid.py`` ``_shard_snapshot_axis``) and gathers the results
back there, as the executors do. A large window is placed instead
(:func:`place_window`): each device's lanes, Δ rows and copy of the
common graph are put on it once and stay, and a step
(:meth:`PlacedWindow.step`) broadcasts the common graph's ``[n]``
fixpoint row to every device and leaves each lane's result on its
device, so no device ever holds the whole lane state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import Cell, MeshAxes, P
from repro_torch.graph.edgeset import (
    EdgeBlock,
    EdgeView,
    edge_keys,
    isin_sorted,
    keys_to_edges,
    lane_bucket,
    make_block,
    stack_delta_blocks,
    unique_keys,
)
from repro_torch.graph.engine import (
    ShardedResult,
    batched_incremental,
    incremental_additions_resident,
    incremental_additions_sharded,
    run_to_fixpoint,
)
from repro_torch.graph.generators import edge_weights, rmat_edges
from repro_torch.graph.semiring import SSSP
from repro_torch.runtime import trace

COMMONGRAPH_SHAPES = {
    # snapshots  nodes        CG edges      Δ edges (per snapshot)
    "window_64x": dict(n_snapshots=64, n_nodes=8_388_608, cg_edges=67_108_864,
                       delta_edges=1_048_576),
    "window_32x": dict(n_snapshots=32, n_nodes=1_048_576, cg_edges=16_777_216,
                       delta_edges=262_144),
}

# The step's query: SSSP from vertex 0, as the reference's cell.
SEMIRING, SOURCE = SSSP, 0


def make_commongraph_cell(shape_id: str, mesh=None,
                          max_iters: int = 64) -> Cell:
    """The ``commongraph/<shape_id>`` cell on ``mesh``: the
    :func:`make_window_cell` of ``COMMONGRAPH_SHAPES[shape_id]``."""
    return make_window_cell(COMMONGRAPH_SHAPES[shape_id], mesh, max_iters,
                            name=f"commongraph/{shape_id}")


def make_window_cell(sizes: dict, mesh=None, max_iters: int = 64, *,
                     name: str) -> Cell:
    """The CommonGraph cell named ``name`` of a window of ``sizes``
    (``n_snapshots``, ``n_nodes``, ``cg_edges``, ``delta_edges``) on
    ``mesh``.

    ``mesh=None`` is the unmeshed launch (extent 1); a ``SnapshotMesh``
    or any object with ``axis_names`` and ``shape`` gives the reference's
    extent, bucket and meta. Only a ``SnapshotMesh`` runs the step: with
    an extent above 1 the step's lane axis is split over the mesh's
    devices, the common graph copied to each, and the results gathered
    onto the first device, whose lanes equal the unmeshed step's bit for
    bit. A large window is placed instead (:func:`place_window`) and
    stepped with nothing gathered.
    """
    s, n = sizes["n_snapshots"], sizes["n_nodes"]
    e_cg, e_d = sizes["cg_edges"], sizes["delta_edges"]
    ax = MeshAxes() if mesh is None else MeshAxes.for_mesh(mesh)
    extent = 1 if mesh is None else ax.n_batch_shards(mesh)
    sb = lane_bucket(s, extent)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    f32, i32 = torch.float32, torch.int32
    values = meta((sb, n), f32)
    parent = meta((sb, n), i32)
    cg = EdgeBlock(meta((e_cg,), i32), meta((e_cg,), i32), meta((e_cg,), f32))
    delta = EdgeBlock(meta((sb, e_d), i32), meta((sb, e_d), i32),
                      meta((sb, e_d), f32))
    lane_valid = meta((sb,), torch.bool)
    # the reference's layout: lanes over the batch axes, edges over model
    bd = ax.batch
    state_spec = P(bd, None)
    cg_spec = EdgeBlock(P(ax.model), P(ax.model), P(ax.model))
    delta_spec = EdgeBlock(P(bd, ax.model), P(bd, ax.model), P(bd, ax.model))

    def evolve_step(values, parent, cg_block, delta_block, lane_valid):
        # track_parents=False, as the reference: the deletion-free hop
        # never trims, so dependence tracking is dead weight.
        with trace.span("cell.step"):
            if extent == 1:
                res = batched_incremental(
                    SEMIRING, n, max_iters, values, parent, (cg_block,),
                    (delta_block,), track_parents=False,
                    lane_valid=lane_valid)
            else:
                res = _sharded_step(mesh, n, max_iters, values, parent,
                                    cg_block, delta_block, lane_valid)
        return res.values, res.parent, res.iterations, res.edge_work

    return Cell(
        name=name,
        fn=evolve_step,
        args=(values, parent, cg, delta, lane_valid),
        in_specs=(state_spec, state_spec, cg_spec, delta_spec, P(bd)),
        out_specs=(state_spec, state_spec, P(bd), P(bd)),
        lane_args=(0, 1, 3, 4),
        donate=(0, 1),
        meta={"lanes": s, "lane_bucket": sb,
              "lanes_per_device": sb // extent,
              "lane_padding_overhead": round(sb / s - 1, 4)},
    )


def _sharded_step(mesh, n, max_iters, values, parent, cg_block, delta_block,
                  lane_valid):
    """The step with its lanes split over a ``SnapshotMesh``: each shard
    seeds from its Δ rows, as the unmeshed step does, and relaxes the
    common graph's copy on its device."""
    from repro_torch.core.trigrid import _shard_snapshot_axis
    from repro_torch.launch.mesh import SnapshotMesh
    if not isinstance(mesh, SnapshotMesh):
        raise TypeError(f"the cell runs on a SnapshotMesh, not "
                        f"{type(mesh).__name__}")
    shards = _shard_snapshot_axis(mesh, values, parent, (delta_block,),
                                  lane_valid)
    with trace.span("shard.replicas"):
        copies = {}
        for shard in shards:
            dev = shard.values.device
            if dev not in copies:
                copies[dev] = EdgeBlock(*(a.to(dev) for a in cg_block))
        shards = [sd._replace(shared_blocks=(copies[sd.values.device],))
                  for sd in shards]
    return incremental_additions_sharded(n, SEMIRING, shards, max_iters,
                                         track_parents=False)


class PlacedWindow(NamedTuple):
    """A CommonGraph window placed on a ``SnapshotMesh`` by
    :func:`place_window`: one ``LaneShard`` per device, without state,
    holding that device's contiguous lanes' Δ rows and ``lane_valid``
    slice and its copy of the common graph."""

    shards: tuple
    num_nodes: int
    max_iters: int

    def step(self, values: torch.Tensor) -> ShardedResult:
        """The cell's step on every lane from the common graph's fixpoint
        ``values`` (``[n]``, on the mesh's first device; parents are not
        tracked, as the unmeshed step's are not): the row broadcast to
        each device and expanded there, each shard seeded from its Δ rows
        and run to its fixpoint, as the unmeshed step, and the results
        left on their devices. Every lane equals the unmeshed step's bit
        for bit (values, iterations, ``edge_work``)."""
        from repro_torch.core.trigrid import _broadcast_lane_state
        with trace.span("cell.step"):
            shards = _broadcast_lane_state(self.shards, values)
            return incremental_additions_resident(
                self.num_nodes, SEMIRING, shards, self.max_iters,
                track_parents=False)


def window_lanes(n_snapshots: int, extent: int) -> int:
    """The lanes of a window of ``n_snapshots`` placed over ``extent``
    devices: as many a device, the fewest that hold every snapshot. A
    placement keeps one shape from set-up to the end, so it needs no
    power-of-two bucket (``lane_bucket``) to bound the shapes it
    launches; its padding lanes (fewer than ``extent``) only even out
    the devices."""
    if n_snapshots < 1 or extent < 1:
        raise ValueError(f"need a snapshot and a device, got "
                         f"{n_snapshots} and {extent}")
    return extent * -(-n_snapshots // extent)


def place_window(sizes: dict, mesh, cg_block: EdgeBlock,
                 delta_block: EdgeBlock, lane_valid: torch.Tensor,
                 max_iters: int = 64) -> PlacedWindow:
    """Put the window of ``sizes`` on ``mesh`` (a ``SnapshotMesh``) once:
    each device gets its contiguous lanes of ``delta_block`` (``[lanes,
    delta_edges]``, ``lanes = window_lanes(n_snapshots, extent)``) and
    of ``lane_valid``, and a copy of ``cg_block`` (``[cg_edges]``), where
    they stay (``core/trigrid.py`` ``_place_snapshot_axis``, span
    ``shard.place``). The arguments may lie on any device and may be
    freed afterwards."""
    from repro_torch.core.trigrid import _place_snapshot_axis
    from repro_torch.launch.mesh import SnapshotMesh
    if not isinstance(mesh, SnapshotMesh):
        raise TypeError(f"a window is placed on a SnapshotMesh, not "
                        f"{type(mesh).__name__}")
    lanes = window_lanes(sizes["n_snapshots"], mesh.shape["data"])
    want = dict(cg=(sizes["cg_edges"],),
                delta=(lanes, sizes["delta_edges"]), lane_valid=(lanes,))
    got = dict(cg=tuple(cg_block.src.shape),
               delta=tuple(delta_block.src.shape),
               lane_valid=tuple(lane_valid.shape))
    if got != want:
        raise ValueError(f"the window's arguments have shapes {got}, not "
                         f"{want}")
    shards = _place_snapshot_axis(mesh, (delta_block,), lane_valid,
                                  (cg_block,))
    return PlacedWindow(tuple(shards), sizes["n_nodes"], max_iters)


class CommonGraphInputs(NamedTuple):
    """Concrete arguments of a CommonGraph cell, in ``Cell.args`` order."""

    values: torch.Tensor      # float32 [sb, n]: the common graph's fixpoint
    parent: torch.Tensor      # int32 [sb, n]: its parents
    cg: EdgeBlock             # [cg_edges], dst-sorted
    delta: EdgeBlock          # [sb, delta_edges], each lane dst-sorted
    lane_valid: torch.Tensor  # bool [sb]; False = padding lane


def commongraph_edges(shape_id: str, extent: int = 1, seed: int = 0):
    """The cell's edges as CPU tensors, from numpy: ``(cg, delta,
    lane_valid)``.

    The common graph is ``rmat_edges(n, cg_edges, seed)``, weighted by
    ``edge_weights`` (a pure function of the edge key), dst-sorted and
    padded with the sentinel to exactly ``cg_edges``. Each valid lane's Δ
    is exactly ``delta_edges`` distinct edges that are not in the common
    graph, drawn uniformly as the sequence generator draws its additions
    (``make_evolving_sequence``), so the lane's snapshot is the common
    graph plus the edges it lacks; padding lanes are all sentinel.
    Deterministic in ``seed``.
    """
    sh = COMMONGRAPH_SHAPES[shape_id]
    s, n = sh["n_snapshots"], sh["n_nodes"]
    e_cg, e_d = sh["cg_edges"], sh["delta_edges"]
    sb = lane_bucket(s, extent)
    src, dst = rmat_edges(n, e_cg, seed=seed)
    cg_keys = edge_keys(src, dst, n)
    cg = make_block(src, dst, edge_weights(cg_keys), n, granule=e_cg,
                    device="cpu")
    cg_keys.sort()
    rng = np.random.default_rng(seed + 1)
    lanes = []
    for _ in range(s):
        keys = np.empty(0, dtype=np.int64)
        while keys.shape[0] < e_d:
            m = e_d - keys.shape[0]
            m += m // 8 + 64
            a = rng.integers(0, n, size=m)
            b = rng.integers(0, n, size=m)
            ok = a != b
            cand = unique_keys(edge_keys(a[ok], b[ok], n))
            cand = cand[~isin_sorted(cand, cg_keys)]
            keys = unique_keys(np.concatenate([keys, cand]))
        keys = np.sort(rng.permutation(keys)[:e_d])
        lanes.append((*keys_to_edges(keys, n), edge_weights(keys)))
    delta = stack_delta_blocks(lanes, n, granule=e_d, num_lanes=sb,
                               device="cpu")
    return cg, delta, torch.arange(sb) < s


def commongraph_inputs(shape_id: str, extent: int = 1, seed: int = 0,
                       device: str | torch.device = "cuda",
                       edges=None) -> CommonGraphInputs:
    """Concrete inputs of the cell at ``extent`` on ``device``: the edges
    of :func:`commongraph_edges` (or ``edges``, its result) and the start
    state, the SSSP fixpoint of the common graph from vertex 0 (parents
    tracked), broadcast to every lane."""
    cg, delta, lane_valid = (commongraph_edges(shape_id, extent, seed)
                             if edges is None else edges)
    n = COMMONGRAPH_SHAPES[shape_id]["n_nodes"]
    cg, delta = (EdgeBlock(*(a.to(device) for a in b)) for b in (cg, delta))
    start = run_to_fixpoint(EdgeView((cg,), n), SEMIRING, SOURCE)
    sb = lane_valid.shape[0]
    return CommonGraphInputs(start.values.expand(sb, n).contiguous(),
                             start.parent.expand(sb, n).contiguous(),
                             cg, delta, lane_valid.to(device))


def lane_view(inputs: CommonGraphInputs, lane: int) -> EdgeView:
    """Lane ``lane``'s snapshot: the common graph plus its Δ row."""
    row = EdgeBlock(*(a[lane] for a in inputs.delta))
    return EdgeView((inputs.cg, row), inputs.values.shape[1])

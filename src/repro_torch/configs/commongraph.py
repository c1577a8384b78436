"""The paper's own engine at production scale, run concretely on the card.

Counterpart of ``repro.configs.commongraph``: the batched Direct-Hop step
of CommonGraph — one lane per snapshot, each lane the common graph's
fixpoint carried to its snapshot by the addition-only hop over its Δ
edges — at the two protocol scales of ``COMMONGRAPH_SHAPES``. The lane
axis is padded to ``lane_bucket(snapshots, extent)`` with masked lanes,
so the cell shards for any snapshot count on a mesh of any extent.

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
relaxes every edge itself. Only the lane axis is split
(``core/trigrid.py`` ``_shard_snapshot_axis``).
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
    batched_incremental,
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
    """The ``commongraph/<shape_id>`` cell on ``mesh``.

    ``mesh=None`` is the unmeshed launch (extent 1); a ``SnapshotMesh``
    or any object with ``axis_names`` and ``shape`` gives the reference's
    extent, bucket and meta. Only a ``SnapshotMesh`` runs the step: with
    an extent above 1 its lane axis is split over the mesh's devices, the
    common graph copied to each, and the results gathered onto the first
    device, whose lanes equal the unmeshed step's bit for bit.
    """
    sh = COMMONGRAPH_SHAPES[shape_id]
    s, n = sh["n_snapshots"], sh["n_nodes"]
    e_cg, e_d = sh["cg_edges"], sh["delta_edges"]
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
        name=f"commongraph/{shape_id}",
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

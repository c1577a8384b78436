"""The CommonGraph window placed on a ``SnapshotMesh`` with each device's
lanes kept on it (``repro_torch.configs.commongraph`` ``place_window``,
``PlacedWindow.step``; ``core/trigrid.py`` ``_place_snapshot_axis`` and
``_broadcast_lane_state``; ``graph/engine.py``
``incremental_additions_resident``), held against the unmeshed step.

At a small shape (5 snapshots, 2^10 vertices) on meshes of the CPU named
two and four times, with padding lanes (``window_lanes``: 6 and 8 lanes,
as many a device): every lane equals the unmeshed
``batched_incremental`` bit for bit (values, iterations, ``edge_work``)
and the plain reference of the benchmark (``bench/reference.py``) on its
own snapshot; the copies between shards are counted as the layout
predicts; no ``[lanes, N]`` tensor is ever made; and the sized
constructor gives the registered shapes' cells.
"""

import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from _torch_inputs import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import commongraph as tcg  # noqa: E402
from repro_torch.graph import engine  # noqa: E402
from repro_torch.graph.edgeset import (  # noqa: E402
    EdgeBlock, EdgeView, lane_bucket)
from repro_torch.launch.mesh import make_snapshot_mesh  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from bench.reference import solve  # noqa: E402

SMALL = "resident_5x"
SIZES = dict(n_snapshots=5, n_nodes=1024, cg_edges=8192, delta_edges=512)
N = SIZES["n_nodes"]


@pytest.fixture
def small(monkeypatch):
    """The small shape in the port's registry (its materializer reads it
    there)."""
    monkeypatch.setitem(tcg.COMMONGRAPH_SHAPES, SMALL, dict(SIZES))
    return SMALL


@pytest.fixture(autouse=True)
def _fresh_trace():
    trace.reset()
    yield
    trace.reset()


def _bits(t):
    return t.contiguous().view(torch.int32) if t.dtype == torch.float32 \
        else t


def _placed(shape_id, extent, seed=0, max_iters=64):
    """The cell's inputs (lanes bucketed, padding at the end) and the
    window placed from their first ``window_lanes`` lanes."""
    inputs = tcg.commongraph_inputs(shape_id, extent=extent, seed=seed,
                                    device="cpu")
    lanes = tcg.window_lanes(SIZES["n_snapshots"], extent)
    mesh = make_snapshot_mesh(["cpu"] * extent)
    window = tcg.place_window(
        SIZES, mesh, inputs.cg, EdgeBlock(*(a[:lanes]
                                                   for a in inputs.delta)),
        inputs.lane_valid[:lanes], max_iters)
    return inputs, window


def _lanes(res):
    """Every lane's row of every field of a ``ShardedResult``, in lane
    order."""
    return [engine.FixpointResult(*(None if t is None else t[i] for t in r))
            for r in res.shards for i in range(r.values.shape[0])]


# -- the placed step against the unmeshed step and the plain reference -------

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("extent", [2, 4])
def test_placed_step_equals_unmeshed_lane_for_lane(small, extent, seed):
    """Every lane of the placed step, padding lanes included, equals the
    unmeshed ``batched_incremental`` step bit for bit: values, iterations
    and ``edge_work``; each shard's lanes lie on their shard."""
    inputs, window = _placed(small, extent, seed)
    lanes = tcg.window_lanes(SIZES["n_snapshots"], extent)
    assert lanes > SIZES["n_snapshots"] and len(window.shards) == extent
    want = tcg.make_commongraph_cell(small).fn(*inputs)
    got = window.step(inputs.values[0])
    assert [r.values.shape[0] for r in got.shards] == \
        [lanes // extent] * extent
    rows = _lanes(got)
    assert len(rows) == lanes
    for lane, r in enumerate(rows):
        for name, g, w in (("values", r.values, want[0][lane]),
                           ("iterations", r.iterations, want[2][lane]),
                           ("edge_work", r.edge_work, want[3][lane])):
            assert torch.equal(_bits(g), _bits(w)), (name, lane)
    per = lanes // extent
    assert [int(r.lane_valid.sum()) for r in window.shards] == \
        [int(inputs.lane_valid[d * per:(d + 1) * per].sum())
         for d in range(extent)]
    assert len(got.rows()) == lanes
    for row, want_row in zip(got.rows(), want[0]):
        assert torch.equal(_bits(row), _bits(want_row))


@pytest.mark.parametrize("extent", [2, 4])
def test_placed_step_equals_the_plain_reference(small, extent):
    """Each valid lane equals the benchmark's plain reference (frontier
    Bellman-Ford in plain PyTorch) on its own snapshot's edge list, from
    the cell's source, bit for bit."""
    inputs, window = _placed(small, extent, seed=2)
    rows = window.step(inputs.values[0]).rows()
    for lane in range(SIZES["n_snapshots"]):
        parts = [tuple(inputs.cg), tuple(a[lane] for a in inputs.delta)]
        want, = solve(parts, N, [tcg.SOURCE])
        assert torch.equal(_bits(rows[lane]), _bits(want)), lane


# -- what the step copies between shards, and what it never builds -----------

@pytest.mark.parametrize("extent", [2, 4])
def test_copied_bytes_are_the_broadcast_rows(small, extent):
    """``shard.copied_bytes`` a step: ``(extent - 1) * N * 4`` bytes for
    the ``[N]`` values row broadcast (parents are made on each shard),
    plus the fixpoint loop's per-shard scalars: a flag byte per later
    shard a flag read and a 4-byte sweep count per later shard. The
    placement's copies from the first device count as well, per later
    shard."""
    inputs, window = _placed(small, extent)
    with trace.recording():
        window.step(inputs.values[0])
    got = trace.totals()
    flags = got["counts"]["engine.rounds"]
    assert got["counts"]["shard.copied_bytes"] == (extent - 1) * (
        N * 4 + flags + 4)
    assert got["spans"]["shard.broadcast"]["count"] == 1
    assert got["spans"]["cell.step"]["count"] == 1
    # the copies' device span, on the CPU by the host clock, lies inside
    # the broadcast's span
    assert 0 < got["counts"]["shard.broadcast_device_ns"] \
        <= 1e9 * got["spans"]["shard.broadcast"]["total_s"]
    trace.reset()
    with trace.recording():
        _placed(small, extent)
    got = trace.totals()
    per = tcg.window_lanes(SIZES["n_snapshots"], extent) // extent
    shard_bytes = 12 * SIZES["cg_edges"] + per * (12 * SIZES["delta_edges"]
                                                  + 1)
    assert got["counts"]["shard.copied_bytes"] == (extent - 1) * shard_bytes
    assert got["spans"]["shard.place"]["count"] == 1


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("extent", [2, 4])
def test_step_builds_no_whole_lane_state(small, extent):
    """No operation of the placed step returns a tensor of more lanes of
    ``[N]`` state than one shard holds, nor the plain relax's flat
    ``[lanes * (N + 1)]`` candidates of the whole launch: nothing is
    gathered; the unmeshed step, by contrast, makes both."""
    inputs, window = _placed(small, extent)
    lanes = tcg.window_lanes(SIZES["n_snapshots"], extent)
    per = lanes // extent
    sb = lane_bucket(SIZES["n_snapshots"])      # the unmeshed step's
    row = inputs.values[0].clone()

    def whole(shape):
        return (len(shape) >= 2 and shape[-1] in (N, N + 1)
                and shape[0] > per) or \
            shape in ((lanes * (N + 1),), (sb * (N + 1),))

    with _Shapes() as seen:
        window.step(row)
    assert seen.shapes and not [s for s in seen.shapes if whole(s)]
    with _Shapes() as seen:
        tcg.make_commongraph_cell(small).fn(*inputs)
    assert (sb, N) in seen.shapes and (sb * (N + 1),) in seen.shapes


# -- the fixpoint loop's shard counters ---------------------------------------

def test_idle_shard_rounds_count_the_shards_sitting_out(small):
    """``engine.shard_rounds`` adds each round's shards and
    ``engine.idle_shard_rounds`` those skipped: on four shards of two
    lanes, the last all padding, that shard sits out every round. A call
    of one shard, the unmeshed step's or the common graph's fixpoint,
    counts neither."""
    inputs, window = _placed(small, 4)
    with trace.recording():
        window.step(inputs.values[0])
    counts = trace.totals()["counts"]
    rounds = counts["engine.rounds"] - 1       # the loop's rounds
    assert counts["engine.shard_rounds"] == 4 * rounds
    assert counts["engine.idle_shard_rounds"] >= rounds
    trace.reset()
    with trace.recording():
        tcg.make_commongraph_cell(small).fn(*inputs)
        engine.run_to_fixpoint(EdgeView((inputs.cg,), N),
                               tcg.SEMIRING, tcg.SOURCE)
    counts = trace.totals()["counts"]
    assert counts["engine.rounds"] > 0
    assert "engine.shard_rounds" not in counts
    assert "engine.idle_shard_rounds" not in counts


def test_resident_additions_equal_the_gathered_launch(small):
    """``incremental_additions_resident`` equals
    ``incremental_additions_sharded`` lane for lane on the same shards,
    ``unstable`` counts and parents included, with parents tracked."""
    inputs = tcg.commongraph_inputs(small, extent=2, seed=3, device="cpu")
    mesh = make_snapshot_mesh(["cpu"] * 2)
    from repro_torch.core.trigrid import _shard_snapshot_axis
    shards = [s._replace(shared_blocks=(inputs.cg,)) for s in
              _shard_snapshot_axis(mesh, inputs.values, inputs.parent,
                                   (inputs.delta,), inputs.lane_valid)]
    want = engine.incremental_additions_sharded(N, tcg.SEMIRING, shards, 64)
    got = engine.incremental_additions_resident(N, tcg.SEMIRING, shards, 64)
    assert len(_lanes(got)) == want.values.shape[0]
    for lane, r in enumerate(_lanes(got)):
        for g, w in zip(r, (t[lane] for t in want)):
            assert torch.equal(_bits(g), _bits(w)), lane


# -- the sized constructor and the placement's refusals ------------------------

@pytest.mark.parametrize("extent", [None, 2, 4])
@pytest.mark.parametrize("shape_id", sorted(tcg.COMMONGRAPH_SHAPES))
def test_registered_cells_equal_the_sized_constructor(shape_id, extent):
    """``make_commongraph_cell(shape_id)`` is ``make_window_cell`` of the
    registered sizes: name, arguments' shapes and dtypes, specs, lane
    arguments, donation and meta; ``make_window_cell`` has no default
    name."""
    mesh = None if extent is None else make_snapshot_mesh(["cpu"] * extent)
    got = tcg.make_commongraph_cell(shape_id, mesh, max_iters=7)
    sized = tcg.make_window_cell(dict(tcg.COMMONGRAPH_SHAPES[shape_id]),
                                 mesh, max_iters=7,
                                 name=f"commongraph/{shape_id}")
    assert got.name == sized.name == f"commongraph/{shape_id}"
    leaves = [engine._tensors(c.args) for c in (got, sized)]
    assert [(tuple(t.shape), t.dtype, t.device.type) for t in leaves[0]] \
        == [(tuple(t.shape), t.dtype, t.device.type) for t in leaves[1]]
    assert tuple(got.in_specs) == tuple(sized.in_specs)
    assert tuple(got.out_specs) == tuple(sized.out_specs)
    assert (got.lane_args, got.donate, got.meta) == \
        (sized.lane_args, sized.donate, sized.meta)
    with pytest.raises(TypeError, match="name"):
        tcg.make_window_cell(tcg.COMMONGRAPH_SHAPES[shape_id])


@pytest.mark.parametrize("snapshots,extent,want", [
    (192, 4, 192), (256, 4, 256), (5, 4, 8), (5, 2, 6), (1, 4, 4),
    (5, 1, 5)])
def test_window_lanes_are_as_many_a_device(snapshots, extent, want):
    """A placed window's lanes: the fewest that hold every snapshot with
    as many a device, no power-of-two bucket (192 snapshots on four
    devices are 48 a device, not the bucket's 64)."""
    assert tcg.window_lanes(snapshots, extent) == want
    assert want % extent == 0 and want - snapshots < extent


def test_place_window_refuses_other_meshes_and_shapes(small):
    """A stand-in mesh, a lane count other than ``window_lanes`` (the
    cell's power-of-two bucket among them), lanes that do not divide over
    the devices, no snapshot, and a row on another device than the first
    shard's are refused."""
    import types
    inputs = tcg.commongraph_inputs(small, extent=4, seed=0, device="cpu")
    stub = types.SimpleNamespace(axis_names=("data",), shape={"data": 4})
    with pytest.raises(TypeError, match="SnapshotMesh"):
        tcg.place_window(SIZES, stub, inputs.cg, inputs.delta,
                         inputs.lane_valid)
    with pytest.raises(ValueError, match="shapes"):
        tcg.place_window(SIZES, make_snapshot_mesh(["cpu"] * 4),
                         inputs.cg, inputs.delta, inputs.lane_valid[:6])
    assert inputs.delta.src.shape[0] == lane_bucket(5, 2) == 8
    with pytest.raises(ValueError, match="shapes"):
        tcg.place_window(SIZES, make_snapshot_mesh(["cpu"] * 2),
                         inputs.cg, inputs.delta, inputs.lane_valid)
    from repro_torch.core.trigrid import _place_snapshot_axis
    with pytest.raises(ValueError, match="divide"):
        _place_snapshot_axis(make_snapshot_mesh(["cpu"] * 4),
                             (EdgeBlock(*(a[:6] for a in inputs.delta)),),
                             inputs.lane_valid[:6])
    with pytest.raises(ValueError, match="snapshot"):
        tcg.window_lanes(0, 4)
    window = tcg.place_window(SIZES, make_snapshot_mesh(["cpu"] * 4),
                              inputs.cg, inputs.delta, inputs.lane_valid)
    with pytest.raises(ValueError, match="first shard"):
        window.step(inputs.values[0].to("meta"))
    assert np.all([s.values is None for s in window.shards])

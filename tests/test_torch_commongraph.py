"""The paper's engine at production scale in the port
(``repro_torch.configs.commongraph``, ``configs/base.py``), held against the
JAX package's ``repro.configs.commongraph``.

The reference builds its cell without devices: its mesh is only read for
``axis_names`` and ``shape``, so a stub stands in for it. At a small shape
registered in both packages' ``COMMONGRAPH_SHAPES`` (5 snapshots, bucket 8,
2^10 vertices, 2^13 common-graph edges, 2^9 Δ edges), the same numpy
inputs go through the reference's step, unjitted and unmeshed, and the
port's. Tolerance everywhere: none, bit for bit.
"""

import types

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import commongraph as jcg  # noqa: E402
from repro.graph.edgeset import EdgeBlock as JEdgeBlock  # noqa: E402
from repro.graph.edgeset import EdgeView as JEdgeView  # noqa: E402
from repro.graph.engine import run_to_fixpoint as j_run_to_fixpoint  # noqa: E402
from repro.graph.semiring import SSSP as J_SSSP  # noqa: E402
from _torch_inputs import one_torch_thread  # noqa: E402,F401
from repro_torch.configs import commongraph as tcg  # noqa: E402
from repro_torch.configs.base import Cell, MeshAxes  # noqa: E402
from repro_torch.graph.edgeset import edge_keys  # noqa: E402
from repro_torch.graph.engine import run_to_fixpoint  # noqa: E402
from repro_torch.launch.mesh import make_snapshot_mesh  # noqa: E402

SMALL = "small_5x"
SMALL_SHAPE = dict(n_snapshots=5, n_nodes=1024, cg_edges=8192,
                   delta_edges=512)
NP_DTYPE = {torch.float32: np.float32, torch.int32: np.int32,
            torch.bool: np.bool_}


@pytest.fixture
def small(monkeypatch):
    """The small shape in both packages' registries."""
    monkeypatch.setitem(jcg.COMMONGRAPH_SHAPES, SMALL, dict(SMALL_SHAPE))
    monkeypatch.setitem(tcg.COMMONGRAPH_SHAPES, SMALL, dict(SMALL_SHAPE))
    return SMALL


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(got, want, msg=""):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=msg)


def _stub(**shape):
    """A mesh as the reference's cell reads it: axis names and extents."""
    return types.SimpleNamespace(axis_names=tuple(shape), shape=dict(shape))


def _leaves(args):
    out = []
    for a in args:
        out.extend(a if isinstance(a, tuple) else (a,))
    return out


def _reference_step(inputs, shape_id):
    """The reference cell's step, unjitted and unmeshed, on the port's
    CPU inputs as numpy."""
    cell = jcg.make_commongraph_cell(shape_id, _stub(data=1, model=1))
    j = [jnp.asarray(_np(inputs.values)), jnp.asarray(_np(inputs.parent)),
         JEdgeBlock(*(jnp.asarray(_np(a)) for a in inputs.cg)),
         JEdgeBlock(*(jnp.asarray(_np(a)) for a in inputs.delta)),
         jnp.asarray(_np(inputs.lane_valid))]
    return cell.fn(*j)


# -- (1) the shapes -----------------------------------------------------------

def test_commongraph_shapes_equal_the_reference():
    assert tcg.COMMONGRAPH_SHAPES == jcg.COMMONGRAPH_SHAPES
    assert list(tcg.COMMONGRAPH_SHAPES) == list(jcg.COMMONGRAPH_SHAPES)


# -- (2) the cell against the reference's, for every mesh ---------------------

MESHES = {
    "none": (None, _stub(data=1, model=1)),
    "1": (1, _stub(data=1, model=1)),
    "2": (2, _stub(data=2, model=1)),
    "4": (4, _stub(data=4, model=2)),
    "8": (8, _stub(data=8, model=1)),
    "pod": ("pod", _stub(pod=2, data=16, model=4)),
}


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("shape_id", sorted(jcg.COMMONGRAPH_SHAPES))
def test_cell_matches_the_reference_cell(shape_id, mesh_id):
    """Name, meta, donation and every argument's shape and dtype (meta
    tensors against the reference's ShapeDtypeStructs) equal the
    reference's at extents 1, 2, 4, 8 and on a multi-pod
    ``("pod", "data", "model")`` stand-in; the lane arguments are those
    the reference splits over its batch axes."""
    port_mesh, ref_mesh = MESHES[mesh_id]
    if isinstance(port_mesh, int):
        port_mesh = make_snapshot_mesh(["cpu"] * port_mesh)
    elif port_mesh == "pod":
        port_mesh = ref_mesh
    cell = tcg.make_commongraph_cell(shape_id, port_mesh)
    ref = jcg.make_commongraph_cell(shape_id, ref_mesh)
    assert isinstance(cell, Cell)
    assert cell.name == ref.name == f"commongraph/{shape_id}"
    assert cell.meta == ref.meta
    assert cell.donate == ref.donate
    assert isinstance(cell.args[2], tcg.EdgeBlock)
    assert isinstance(cell.args[3], tcg.EdgeBlock)
    got, want = _leaves(cell.args), _leaves(ref.args)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert tuple(g.shape) == tuple(w.shape)
        assert np.dtype(NP_DTYPE[g.dtype]) == np.dtype(w.dtype)
    batch = set(MeshAxes.for_mesh(ref_mesh).batch)

    def lane_split(spec):
        if isinstance(spec, JEdgeBlock):
            spec = spec.src
        first = spec[0] if len(spec) else None
        return bool(batch & set((first,) if isinstance(first, str)
                                else first or ()))

    assert cell.lane_args == tuple(i for i, spec in enumerate(ref.in_specs)
                                   if lane_split(spec))


def test_mesh_axes_match_the_reference():
    """``MeshAxes`` on the port's mesh and on stand-ins equals the
    reference's ``MeshAxes`` on the same stand-ins."""
    from repro.configs.base import MeshAxes as JMeshAxes
    for shape in (dict(data=4), dict(data=2, model=8),
                  dict(pod=3, data=4, model=2)):
        stub = _stub(**shape)
        got, want = MeshAxes.for_mesh(stub), JMeshAxes.for_mesh(stub)
        assert (got.batch, got.fsdp, got.model) == (want.batch, want.fsdp,
                                                   want.model)
        assert got.n_batch_shards(stub) == want.n_batch_shards(stub)
    mesh = make_snapshot_mesh(["cpu"] * 4)
    assert MeshAxes.for_mesh(mesh).n_batch_shards(mesh) == 4


# -- (3) the step against the reference's, bit for bit ------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_small_cell_step_equals_the_reference(small, seed):
    """At the small shape the port's step and the reference's, on the
    same inputs, give equal values, parents, iterations and edge_work bit
    for bit; the start state equals the reference's fixpoint of the
    common graph."""
    inputs = tcg.commongraph_inputs(small, seed=seed, device="cpu")
    n = SMALL_SHAPE["n_nodes"]
    ref_start = j_run_to_fixpoint(
        JEdgeView((JEdgeBlock(*(jnp.asarray(_np(a)) for a in inputs.cg)),),
                  n), J_SSSP, 0)
    for lane in range(inputs.values.shape[0]):
        _same(inputs.values[lane], ref_start.values)
        _same(inputs.parent[lane], ref_start.parent)
    cell = tcg.make_commongraph_cell(small)
    got = cell.fn(*inputs)
    want = _reference_step(inputs, small)
    for name, g, w in zip(("values", "parent", "iterations", "edge_work"),
                          got, want):
        assert np.dtype(NP_DTYPE[g.dtype]) == np.asarray(w).dtype, name
        _same(g, w, name)
    iters = _np(got[2])
    assert (iters[:5] > 1).all() and (iters[5:] == 0).all()
    assert (_np(got[3])[5:] == 0.0).all()


# -- (4) the meshed CPU runs against the unmeshed run -------------------------

@pytest.mark.parametrize("extent", [2, 4])
def test_small_cell_on_cpu_mesh_equals_unmeshed(small, extent):
    """The cell on ``make_snapshot_mesh(["cpu"] * k)`` splits its 8 lanes
    into k shards and equals the unmeshed step bit for bit."""
    inputs = tcg.commongraph_inputs(small, extent=extent, seed=0,
                                    device="cpu")
    mesh = make_snapshot_mesh(["cpu"] * extent)
    cell = tcg.make_commongraph_cell(small, mesh)
    assert cell.meta["lanes_per_device"] == 8 // extent
    want = tcg.make_commongraph_cell(small).fn(*inputs)
    got = cell.fn(*inputs)
    for g, w in zip(got, want):
        assert g.device == w.device
        _same(g, w)


def test_sharded_step_needs_a_snapshot_mesh(small):
    """A stand-in mesh gives the reference's meta but cannot run the step."""
    inputs = tcg.commongraph_inputs(small, extent=4, seed=0, device="cpu")
    cell = tcg.make_commongraph_cell(small, _stub(data=4, model=1))
    with pytest.raises(TypeError, match="SnapshotMesh"):
        cell.fn(*inputs)


# -- (5) every lane is its snapshot's fixpoint; the materializer --------------

def test_small_cell_lanes_equal_from_scratch(small):
    """Every valid lane equals the port's from-scratch fixpoint of its
    snapshot (the common graph plus its Δ row) bit for bit."""
    inputs = tcg.commongraph_inputs(small, seed=1, device="cpu")
    values = tcg.make_commongraph_cell(small).fn(*inputs)[0]
    for lane in range(SMALL_SHAPE["n_snapshots"]):
        scratch = run_to_fixpoint(tcg.lane_view(inputs, lane), tcg.SEMIRING,
                                  tcg.SOURCE, track_parents=False)
        _same(values[lane], scratch.values, f"lane {lane}")


def test_materializer_lengths_disjoint_and_deterministic(small):
    """Exact lengths (the common graph padded to ``cg_edges``, every Δ row
    ``delta_edges`` real edges, padding lanes all sentinel), Δ keys
    distinct and disjoint from the common graph's, weights a function of
    the key, and the same arrays from the same seed."""
    n, s = SMALL_SHAPE["n_nodes"], SMALL_SHAPE["n_snapshots"]
    cg, delta, lane_valid = tcg.commongraph_edges(small, seed=2)
    again = tcg.commongraph_edges(small, seed=2)
    other = tcg.commongraph_edges(small, seed=3)
    assert tuple(cg.src.shape) == (SMALL_SHAPE["cg_edges"],)
    assert tuple(delta.src.shape) == (8, SMALL_SHAPE["delta_edges"])
    _same(lane_valid, np.arange(8) < s)
    for a, b in zip((*cg, *delta, lane_valid), (*again[0], *again[1],
                                                again[2])):
        _same(a, b)
    assert not torch.equal(delta.src, other[1].src)
    real = _np(cg.dst) < n
    assert (np.diff(_np(cg.dst)) >= 0).all()
    cg_keys = edge_keys(_np(cg.src)[real], _np(cg.dst)[real], n)
    assert np.unique(cg_keys).size == cg_keys.size
    for lane in range(8):
        src, dst, w = (_np(a[lane]) for a in delta)
        if lane >= s:
            assert (dst == n).all() and (src == 0).all() and (w == 0).all()
            continue
        assert (dst < n).all() and (src != dst).all()
        assert (np.diff(dst) >= 0).all()
        keys = edge_keys(src, dst, n)
        assert np.unique(keys).size == SMALL_SHAPE["delta_edges"]
        assert not np.isin(keys, cg_keys).any()
        _same(w, tcg.edge_weights(keys))


def test_cell_defaults_to_the_card():
    """The materializer takes an explicit device and defaults to cuda: no
    CPU fallback."""
    import inspect
    params = inspect.signature(tcg.commongraph_inputs).parameters
    assert params["device"].default == "cuda"

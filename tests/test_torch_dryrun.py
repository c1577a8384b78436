"""The port's dry run (``repro_torch.launch.dryrun``) and what it stands on,
held against the JAX package where it has a counterpart: the partition
specs and ``shard_shape`` (against ``NamedSharding.shard_shape``), the
production and local meshes, the kernels' meta paths (against their plain
versions' output and gradient shapes), the meta tracer's accounting, the
CommonGraph records (against the reference's cell on its abstract
meshes), and the CLI. The model cells are in
``test_torch_dryrun_{lm,lm_moe,gnn,recsys}.py``, one file per family.
"""

import json
import math

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from _torch_dryrun import J_MESHES, T_MESHES, j_bytes, j_outputs  # noqa: E402
from _torch_inputs import edges, messages, state  # noqa: E402
from repro.configs import commongraph as jcg  # noqa: E402
from repro_torch.configs import all_cells, make_cell, shapes_for  # noqa: E402
from repro_torch.configs.base import P, per_device_bytes, shard_shape  # noqa: E402
from repro_torch.kernels import embedding_bag, relax_multi, segment_reduce  # noqa: E402
from repro_torch.kernels.segment_reduce import gather_rows, segment_layout  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.meta_trace import ALLOC_GRANULE, MetaTrace, trace_step  # noqa: E402

SPECS = [
    ((), ()), ((2048,), ("data",)), ((2048,), (("data", "model"),)),
    ((256, 64), (None, "model")), ((4096, 32), (("pod", "data"), None)),
    ((64, 2048, 16), (None, "data", "model")),
    ((32, 64, 16, 8), (None, ("data",), "model", None)),
    ((2449029 + 379, 100), (("data", "model"), None)),
    ((2449029, 100), (("data", "model"), None)),       # uneven: raises
    ((100,), ("model",)),                               # uneven: raises
    ((1, 524288), (None, ("data", "model"))),
    ((24, 100), (("pod", "data", "model"), None)),      # uneven: raises
]


# -- (1) partition specs and shard shapes --------------------------------------

def _names(dims):
    return {a for d in dims if d is not None
            for a in (d if isinstance(d, tuple) else (d,))}


@pytest.mark.parametrize("shape,dims,mesh_id", [
    (shape, dims, m) for shape, dims in SPECS for m in (0, 1)
    if _names(dims) <= set(J_MESHES[m].axis_names)])
def test_shard_shape_follows_jax(shape, dims, mesh_id):
    """The port's ``shard_shape`` equals ``NamedSharding.shard_shape`` on
    both production meshes, and raises ``ValueError`` where JAX does (an
    uneven split)."""
    jm, tm = J_MESHES[mesh_id], T_MESHES[mesh_id]
    assert tuple(P(*dims)) == tuple(JP(*dims))
    try:
        want = NamedSharding(jm, JP(*dims)).shard_shape(shape)
    except ValueError:
        with pytest.raises(ValueError, match="does not divide"):
            shard_shape(shape, P(*dims), tm)
        return
    assert shard_shape(shape, P(*dims), tm) == tuple(want)


def test_partition_spec_reads_as_jax_does():
    """One-name tuples read as the name, as JAX normalizes them; a spec is
    one leaf of a tree; ``None`` means replicated; too long a spec and a
    repeated axis raise."""
    for dims in [(("data",), None), (("pod", "data"),), ("model",), ()]:
        assert tuple(P(*dims)) == tuple(JP(*dims))
    assert P(("data",)) == P("data") and len(P(None, "model")) == 2
    mesh = make_production_mesh()
    assert shard_shape((8, 32), None, mesh) == (8, 32)
    with pytest.raises(ValueError, match="entries"):
        shard_shape((16,), P("data", None), mesh)
    with pytest.raises(ValueError, match="twice"):
        shard_shape((16, 16), P("data", "data"), mesh)
    tree = {"a": torch.empty((32, 16), device="meta"),
            "b": (torch.empty((16,), dtype=torch.int32, device="meta"),)}
    specs = {"a": P("data", "model"), "b": (P(),)}
    assert per_device_bytes(tree, specs, mesh) == 2 * 1 * 4 + 16 * 4
    with pytest.raises(ValueError, match="specs"):
        per_device_bytes(tree, {"a": P(), "b": ()}, mesh)


def test_meshes_match_the_reference():
    """The production meshes have the reference's axis names and
    extents and hold no devices; the local mesh is (1, n) and raises
    without a card and without ``devices=``."""
    for jm, tm in zip(J_MESHES, T_MESHES):
        assert tm.axis_names == jm.axis_names
        assert tm.shape == dict(jm.shape) and tm.devices == ()
    local = make_local_mesh(["cpu"])
    assert local.shape == {"data": 1, "model": 1}
    assert local.devices == (torch.device("cpu"),)
    assert make_local_mesh(["cpu"] * 4).shape == {"data": 1, "model": 4}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="found none"):
            make_local_mesh()
    assert len(all_cells(T_MESHES[0])) == 40
    assert [len(shapes_for(a)) for a in ("stablelm-1.6b", "pna", "dien")] \
        == [4, 4, 4]
    with pytest.raises(KeyError):
        make_cell("pna", "train_4k", T_MESHES[0])


# -- (2) the kernels' meta paths --------------------------------------------------

def _grads(out, inputs):
    return torch.autograd.grad(out.sum(), inputs, allow_unused=True)


def _shapes(ts):
    return [None if t is None else (tuple(t.shape), t.dtype) for t in ts]


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
def test_segment_reduce_meta_path_gives_plain_shapes(reduce):
    """On meta, ``segment_reduce`` (and ``gather_rows``) give the plain
    version's output shape and dtype, and under autograd its gradients'
    shapes, and count no launch."""
    data, seg = messages(7, 40, 3, seed=1)
    shapes = []
    for device in ("cpu", "meta"):
        d = torch.from_numpy(data).to(device).requires_grad_()
        s = torch.from_numpy(seg).to(device)
        before = segment_reduce.launches
        out = segment_reduce(d, s, num_segments=7, reduce=reduce)
        assert segment_reduce.launches == before
        h = torch.randn(9, 5).to(device).requires_grad_()
        idx = s.clamp(0, 8)
        rows = gather_rows(h, idx, segment_layout(idx, 9))
        shapes.append(_shapes([out, rows] + list(_grads(out, [d]))
                              + list(_grads(rows, [h]))))
        assert out.device.type == device
    assert shapes[0] == shapes[1]


def test_embedding_bag_meta_path_gives_plain_shapes():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((30, 6)).astype(np.float32)
    ids = rng.integers(0, 30, 50).astype(np.int32)
    bags = np.sort(rng.integers(0, 8, 50)).astype(np.int32)
    w = rng.random(50).astype(np.float32)
    shapes = []
    for device in ("cpu", "meta"):
        t = torch.from_numpy(table).to(device).requires_grad_()
        wt = torch.from_numpy(w).to(device).requires_grad_()
        out = embedding_bag(t, torch.from_numpy(ids).to(device),
                            torch.from_numpy(bags).to(device), wt, n_bags=8)
        shapes.append(_shapes([out] + list(_grads(out, [t, wt]))))
    assert shapes[0] == shapes[1]


@pytest.mark.parametrize("track", [True, False])
def test_relax_multi_meta_path_gives_plain_shapes(track):
    """Shared and stacked blocks over 3 lanes: the outputs' shapes and
    dtypes equal the plain version's; untracked, the caller's parent
    comes back."""
    n, lanes = 64, 3
    vals, parent, fro = state("sssp", n, 4, lanes)
    src, dst, w = edges(n, 200, 5, pad=8)
    rows = [edges(n, 40, 6 + i) for i in range(lanes)]
    stacked = [np.stack([r[i] for r in rows]) for i in range(3)]
    shapes = []
    for device in ("cpu", "meta"):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        p = t(parent)
        out = relax_multi(t(vals), p, t(fro),
                          [(t(src), t(dst), t(w)), tuple(map(t, stacked))],
                          op="min_plus", num_nodes=n, k=2,
                          track_parents=track)
        if device == "meta":
            assert (out[1] is p) == (not track)
        shapes.append(_shapes(out))
    assert shapes[0] == shapes[1]


# -- (3) the meta tracer ----------------------------------------------------------

def _granule(nbytes):
    return -(-nbytes // ALLOC_GRANULE) * ALLOC_GRANULE


def test_trace_counts_storages_once_and_frees_at_the_last_view():
    """A storage is allocated by the operator that makes it, counted once
    whatever views it has, freed when its last view dies; in-place
    operators and views allocate nothing; sizes round up to 512 bytes."""
    tracer = MetaTrace()
    a = torch.empty(1000, device="meta")
    assert tracer.hold([a, a.view(10, 100)]) == _granule(4000)
    with tracer:
        b = a * 2                      # +4096
        v = b.view(10, 100)            # view: nothing
        b.add_(1.0)                    # in place: nothing
        live_b = tracer.live_bytes
        del b                          # v keeps the storage
        still = tracer.live_bytes
        c = torch.empty(3, device="meta")   # +512
        del v                          # b's storage goes
        after = tracer.live_bytes
        del c
    assert live_b == still == 2 * _granule(4000)
    assert after == _granule(4000) + ALLOC_GRANULE
    assert tracer.live_bytes == _granule(4000)
    assert tracer.peak_bytes == 2 * _granule(4000) + ALLOC_GRANULE
    # a * 2 reads and writes 4000 bytes, add_ the same; views and empty 0
    assert tracer.bytes_accessed == 4 * 4000


def test_trace_counts_products_by_the_flop_counter():
    """``mm``/``bmm`` with ``out_dtype`` (``matmul_f32``'s overloads) and
    a float32 ``mm`` count ``2 m n k``; elementwise work counts nothing."""
    a = torch.empty((8, 16), dtype=torch.bfloat16, device="meta")
    b = torch.empty((16, 4), dtype=torch.bfloat16, device="meta")
    ba = torch.empty((3, 8, 16), dtype=torch.bfloat16, device="meta")
    bb = torch.empty((3, 16, 4), dtype=torch.bfloat16, device="meta")

    def step(a, b, ba, bb):
        x = torch.mm(a, b, out_dtype=torch.float32)
        y = torch.bmm(ba, bb, out_dtype=torch.float32)
        return torch.relu(x @ torch.ones((4, 5), device="meta")), y

    out, rec = trace_step(step, (a, b, ba, bb))
    assert rec["flops"] == 2 * 8 * 16 * 4 * 4 + 2 * 8 * 4 * 5
    assert out[0].dtype == out[1].dtype == torch.float32
    assert rec["one_device"]["argument_bytes"] == sum(
        _granule(t.numel() * t.element_size()) for t in (a, b, ba, bb))
    with pytest.raises(ValueError, match="meta"):
        trace_step(step, (torch.empty((8, 16)), b, ba, bb))


# -- (4) the CommonGraph records --------------------------------------------------

@pytest.mark.parametrize("mesh_id", [0, 1])
@pytest.mark.parametrize("shape_id", sorted(jcg.COMMONGRAPH_SHAPES))
def test_commongraph_records_hold_the_reference_layout(shape_id, mesh_id):
    """Per-device argument and output bytes equal the reference cell's
    ``shard_shape`` sums (outputs from ``jax.eval_shape``); the sweep's
    bytes are its inputs read and outputs written once; the collectives
    are the split, the copies and the gather, reckoned from shapes."""
    jm, tm = J_MESHES[mesh_id], T_MESHES[mesh_id]
    jc = jcg.make_commongraph_cell(shape_id, jm)
    rec = dryrun.dryrun_commongraph(shape_id, tm)
    assert rec["cell"] == jc.name and rec["per_sweep"] is True
    assert rec["lane_axis"] == jc.meta
    assert rec["mem_per_device"] == {
        "argument_bytes": j_bytes(jm, jc.in_specs, jc.args),
        "output_bytes": j_bytes(jm, jc.out_specs, j_outputs(jc, jm))}
    sh = jcg.COMMONGRAPH_SHAPES[shape_id]
    n, e, ed = sh["n_nodes"], sh["cg_edges"], sh["delta_edges"]
    per = jc.meta["lanes_per_device"]
    lanes = jc.meta["lane_bucket"]
    state_in = per * n * (4 + 4 + 1) + 12 * e + per * 12 * ed
    state_out = per * n * (4 + 1) + per * (4 + 4)   # parent not written
    assert rec["bytes_accessed"] == state_in + per * 4 + state_out
    assert rec["flops"] == 0
    extent = lanes // per
    moved = lanes - per
    assert rec["collective_bytes"] == {
        "lane_split": moved * (8 * n + 12 * ed + 1),
        "common_graph_copies": (extent - 1) * 12 * e,
        "gather": moved * (8 * n + 16 + 1)}


# -- (5) the CLI -------------------------------------------------------------------

def test_cli_one_cell_writes_the_reference_layout(tmp_path, capsys):
    path = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "train_4k",
                        "--json", str(path)]) == 0
    out = capsys.readouterr().out
    assert "[dryrun] stablelm-1.6b/train_4k mesh={'data': 16, 'model': 16}" \
        in out
    assert "[dryrun] 1 cells OK, 0 failed" in out
    got = json.loads(path.read_text())
    assert got["failures"] == [] and len(got["records"]) == 1
    rec = got["records"][0]
    assert set(rec) == {"cell", "mesh", "lower_s", "compile_s", "flops",
                        "bytes_accessed", "collective_bytes",
                        "mem_per_device", "one_device"}
    assert rec["compile_s"] is None and rec["collective_bytes"] == {}
    assert set(rec["mem_per_device"]) == {"argument_bytes", "output_bytes"}
    assert set(rec["one_device"]) == {"peak_bytes", "argument_bytes",
                                      "temp_bytes"}
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    # the step's state (bf16 weights, f32 m and v) is on the one device
    assert rec["one_device"]["argument_bytes"] > 10 * 1.6e9
    assert math.isfinite(rec["lower_s"])


def test_dryrun_cell_prints_and_returns_one_record(capsys):
    """``dryrun_cell``, the reference's entry for one cell on one mesh:
    the record the CLI writes, printed in the reference's lines."""
    rec = dryrun.dryrun_cell("gcn-cora", "molecule", T_MESHES[1])
    out = capsys.readouterr().out
    assert out.startswith("[dryrun] gcn-cora/molecule mesh={'pod': 2, "
                          "'data': 16, 'model': 16} lower=")
    assert "flops=" in out and "collectives={}" in out
    assert rec["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert rec == dryrun.dryrun_cells("gcn-cora", "molecule",
                                      [T_MESHES[1]])[0] | {
        "lower_s": rec["lower_s"]}


def test_cli_unknown_shape_fails(capsys):
    assert dryrun.main(["--arch", "stablelm-1.6b", "--shape", "nope"]) == 1
    out = capsys.readouterr().out
    assert "[dryrun] 0 cells OK, 1 failed" in out
    assert "  FAIL: stablelm-1.6b nope {'data': 16, 'model': 16}" in out
    assert dryrun.main(["--arch", "resnet", "--shape", "train_4k"]) == 1
    assert "  FAIL: resnet train_4k" in capsys.readouterr().out


def test_trace_key_splits_only_moe_token_groups():
    """The cells record what their steps take from the mesh: a MoE LM's
    train and prefill cells its batch shards (16 or 32 token groups),
    every other cell nothing. The dry run's jobs follow those keys: one
    trace for both meshes but for those four cells."""
    keys = {(a, s): [make_cell(a, s, m).trace_key for m in T_MESHES]
            for a, s in all_cells(T_MESHES[0])}
    split = {k for k, v in keys.items() if v[0] != v[1]}
    assert split == {(a, s) for a in ("qwen3-moe-30b-a3b",
                                      "llama4-maverick-400b-a17b")
                     for s in ("train_4k", "prefill_32k")}
    assert all(v == [16, 32] for k, v in keys.items() if k in split)
    assert all(v == [None, None] for k, v in keys.items() if k not in split)
    assert len(dryrun._jobs(all_cells(T_MESHES[0]), T_MESHES)) == 44

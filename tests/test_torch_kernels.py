"""The port's relax kernels held against the JAX reference, bit for bit.

On the CPU the wrappers run their plain PyTorch versions; these are held
against ``repro``'s ``edge_relax_ref`` / ``relax_multi_ref`` (and, for a
few cases, against the Pallas kernels in interpret mode) with
``assert_array_equal`` — min/max reductions are order-free, so there is
no tolerance. The lane axis of ``relax_multi`` is held against the
reference run lane by lane. The CUDA kernels are held against the plain
versions on a card in ``test_torch_cuda.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.edge_relax.ops import edge_relax as j_edge_relax  # noqa: E402
from repro.kernels.edge_relax.ref import edge_relax_ref as j_edge_relax_ref  # noqa: E402
from repro.kernels.edge_relax_multi import relax_multi as j_relax_multi  # noqa: E402
from repro.kernels.edge_relax_multi import relax_multi_ref as j_relax_multi_ref  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS  # noqa: E402
from repro_torch.kernels import edge_relax, relax_multi  # noqa: E402
from repro_torch.kernels.edge_relax.ref import (  # noqa: E402
    KERNEL_OP_FOR,
    SEMIRING_OPS,
    UnsupportedSemiring,
    ops_for,
)
from _torch_inputs import IDENTITY, SOURCE_VALUE  # noqa: E402
from _torch_inputs import edges as _edges  # noqa: E402
from _torch_inputs import elsewhere  # noqa: E402
from _torch_inputs import state as _state  # noqa: E402
from _torch_inputs import values as _values  # noqa: E402

SEMIRINGS = sorted(ALL_SEMIRINGS)
FUSED_KS = (1, 2, 3, 7)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# -- op table ---------------------------------------------------------------------


def test_kernel_op_table_matches_reference():
    from repro.kernels.edge_relax.edge_relax import (
        KERNEL_OP_FOR as J_OP_FOR, SEMIRING_OPS as J_OPS)
    assert KERNEL_OP_FOR == J_OP_FOR
    assert set(SEMIRING_OPS) == set(J_OPS)
    for op in SEMIRING_OPS:
        assert ops_for(op)[1] == J_OPS[op][1]
        assert np.float32(ops_for(op)[2]) == np.float32(J_OPS[op][2])
    with pytest.raises(UnsupportedSemiring, match="softmin"):
        ops_for("softmin")
    for name, sr in ALL_SEMIRINGS.items():   # the shared test inputs agree
        assert np.float32(IDENTITY[name]) == np.float32(sr.identity)
        assert np.float32(SOURCE_VALUE[name]) == np.float32(sr.source_value)


# -- edge_relax ---------------------------------------------------------------------


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("n,e,seed,dup", [(1, 5, 0, False),
                                          (37, 300, 1, True),
                                          (200, 1500, 2, False)])
def test_edge_relax_matches_reference(name, n, e, seed, dup):
    src, dst, w = _edges(n, e, seed, dup_heavy=dup, pad=17)
    vals = _values(name, n, seed)
    op = KERNEL_OP_FOR[name]
    want = np.asarray(j_edge_relax_ref(jnp.asarray(vals), jnp.asarray(src),
                                       jnp.asarray(dst), jnp.asarray(w),
                                       op=op, num_nodes=n))
    got = _np(edge_relax(*_t(vals, src, dst, w), op=op, num_nodes=n))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", SEMIRINGS)
def test_edge_relax_matches_pallas_interpret(name):
    n = 50
    src, dst, w = _edges(n, 700, 3, dup_heavy=True)
    vals = _values(name, n, 3)
    op = KERNEL_OP_FOR[name]
    want = np.asarray(j_edge_relax(jnp.asarray(vals), jnp.asarray(src),
                                   jnp.asarray(dst), jnp.asarray(w), op=op,
                                   num_nodes=n, use_pallas=True,
                                   interpret=True))
    got = _np(edge_relax(*_t(vals, src, dst, w), op=op, num_nodes=n))
    np.testing.assert_array_equal(got, want)


def test_edge_relax_all_padding_block_gives_identity():
    n = 16
    src, dst, w = _edges(n, 0, 0, pad=4096)
    for name in SEMIRINGS:
        sr = ALL_SEMIRINGS[name]
        got = _np(edge_relax(*_t(_values(name, n, 1), src, dst, w),
                             op=KERNEL_OP_FOR[name], num_nodes=n))
        np.testing.assert_array_equal(got, np.full(n, np.float32(sr.identity)))


def test_edge_relax_viterbi_underflow_flushes_like_reference():
    n = 3
    vals = np.array([1.0, 1e-37, 2e-38], np.float32)
    src = np.array([1, 2, 0], np.int32)
    dst = np.array([0, 1, 2], np.int32)
    w = np.array([1e-3, 1e-3, 0.5], np.float32)
    want = np.asarray(j_edge_relax_ref(*(jnp.asarray(a) for a in
                                         (vals, src, dst, w)),
                                       op="max_times", num_nodes=n))
    got = _np(edge_relax(*_t(vals, src, dst, w), op="max_times",
                         num_nodes=n))
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0 and got[1] == 0.0   # 1e-40 and 2e-41 flushed


def test_edge_relax_rejects_bad_inputs():
    src, dst, w = _t(*_edges(8, 10, 0))
    vals = torch.zeros(8)
    with pytest.raises(TypeError, match="src"):
        edge_relax(vals, src.long(), dst, w, op="min_plus", num_nodes=8)
    with pytest.raises(ValueError, match="values"):
        edge_relax(vals, src, dst, w, op="min_plus", num_nodes=9)
    with pytest.raises(UnsupportedSemiring):
        edge_relax(vals, src, dst, w, op="softmin", num_nodes=8)
    with pytest.raises(ValueError, match="cuda or cpu"):
        edge_relax(vals.to("meta"), src.to("meta"), dst.to("meta"),
                   w.to("meta"), op="min_plus", num_nodes=8)
    before = edge_relax.launches
    edge_relax(vals, src, dst, w, op="min_plus", num_nodes=8)
    assert edge_relax.launches == before     # the plain version counts nothing


# -- relax_multi: one lane vs the reference oracle ------------------------------------


def _j_multi(vals, parent, fro, src, dst, w, allowed, *, op, n, k, track,
             pallas=False):
    args = [jnp.asarray(a) for a in (vals, parent, fro, src, dst, w)]
    kw = dict(op=op, num_nodes=n, k=k, track_parents=track)
    if pallas:
        out = j_relax_multi(*args, jnp.int32(allowed), use_pallas=True,
                            interpret=True, **kw)
    else:
        out = j_relax_multi_ref(*args, jnp.int32(allowed), **kw)
    return [np.asarray(x) for x in out]


def _assert_lane(got, want, lane, msg):
    names = ("values", "parent", "frontier", "sweeps", "work")
    for i, (g, r) in enumerate(zip(got, want)):
        g = _np(g)[lane]
        np.testing.assert_array_equal(g, r, err_msg=f"{msg}: {names[i]}")


@pytest.mark.parametrize("name", SEMIRINGS)
@pytest.mark.parametrize("k", FUSED_KS)
def test_relax_multi_matches_reference(name, k):
    """Mixed/empty/source frontiers, allowed caps below and above k, with
    and without parents, on a padded edge stream."""
    n = 120
    op = KERNEL_OP_FOR[name]
    src, dst, w = _edges(n, 900, k, dup_heavy=(k % 2 == 0), pad=30)
    for case, (frontier, allowed, track) in enumerate(
            (("mixed", k, True), ("mixed", 1, False), ("source", k + 2, True),
             ("empty", k, True), ("mixed", 0, True))):
        vals, parent, fro = _state(name, n, k + case, 1, frontier)
        got = relax_multi(*_t(vals, parent, fro), [_t(src, dst, w)],
                          torch.tensor([allowed], dtype=torch.int32), op=op,
                          num_nodes=n, k=k, track_parents=track)
        want = _j_multi(vals[0], parent[0], fro[0], src, dst, w, allowed,
                        op=op, n=n, k=k, track=track)
        _assert_lane(got, want, 0, f"{name} k={k} case {case}")


@pytest.mark.parametrize("name", SEMIRINGS)
def test_relax_multi_matches_pallas_interpret(name):
    n, k = 40, 3
    op = KERNEL_OP_FOR[name]
    src, dst, w = _edges(n, 300, 5)
    vals, parent, fro = _state(name, n, 5, 1)
    got = relax_multi(*_t(vals, parent, fro), [_t(src, dst, w)], op=op,
                      num_nodes=n, k=k)
    want = _j_multi(vals[0], parent[0], fro[0], src, dst, w, k, op=op, n=n,
                    k=k, track=True, pallas=True)
    _assert_lane(got, want, 0, f"{name} pallas")


@pytest.mark.parametrize("name", SEMIRINGS)
def test_relax_multi_lanes_match_reference_lane_by_lane(name):
    """A shared block plus a stacked per-lane Δ block, per-lane caps, an
    empty lane and an all-padding Δ lane: each lane equals the reference
    on its own edges, and stopped lanes count nothing more."""
    n, lanes, k = 90, 4, 7
    op = KERNEL_OP_FOR[name]
    shared = _edges(n, 500, 11)
    deltas = [_edges(n, m, 20 + i, pad=64 - m)
              for i, m in enumerate((40, 0, 64, 13))]
    stacked = tuple(np.stack([d[i] for d in deltas]) for i in range(3))
    vals, parent, fro = _state(name, n, 3, lanes)
    fro[1] = False
    allowed = np.array([k, k, 2, 5], np.int32)
    got = relax_multi(*_t(vals, parent, fro), [_t(*shared), _t(*stacked)],
                      torch.from_numpy(allowed), op=op, num_nodes=n, k=k)
    for lane in range(lanes):
        edges = [np.concatenate([shared[i], deltas[lane][i]])
                 for i in range(3)]
        want = _j_multi(vals[lane], parent[lane], fro[lane], *edges,
                        allowed[lane], op=op, n=n, k=k, track=True)
        _assert_lane(got, want, lane, f"{name} lane {lane}")
    assert int(got[3][1]) == 0 and float(got[4][1]) == 0.0


def test_relax_multi_work_is_summed_per_block_in_f32():
    """Work adds each block's integer count in block order, in f32 — the
    reference engine's grouping (here the counts are small and exact)."""
    n = 30
    blocks = [_edges(n, m, m) for m in (100, 7, 250)]
    vals, parent, fro = _state("sssp", n, 0, 1, "mixed")
    got = relax_multi(*_t(vals, parent, fro), [_t(*b) for b in blocks],
                      op="min_plus", num_nodes=n, k=1)
    active = sum(int(fro[0][b[0]].sum()) for b in blocks)
    assert float(got[4][0]) == float(active)


def test_relax_multi_rejects_bad_inputs():
    vals, parent, fro = _t(*_state("sssp", 8, 0, 2))
    blk = _t(*_edges(8, 10, 0))
    kw = dict(op="min_plus", num_nodes=8)
    with pytest.raises(ValueError, match="k=0"):
        relax_multi(vals, parent, fro, [blk], k=0, **kw)
    with pytest.raises(ValueError, match="lanes"):
        relax_multi(vals[0], parent[0], fro[0], [blk], k=1, **kw)
    with pytest.raises(ValueError, match="at least one"):
        relax_multi(vals, parent, fro, [], k=1, **kw)
    with pytest.raises(ValueError, match="3 lanes"):
        relax_multi(vals, parent, fro,
                    [tuple(t.expand(3, -1) for t in blk)], k=1, **kw)
    with pytest.raises(TypeError):
        relax_multi(vals, parent.long(), fro, [blk], k=1, **kw)
    with pytest.raises(ValueError, match="cuda, cpu or meta"):
        relax_multi(*elsewhere(vals, parent, fro), [elsewhere(*blk)], k=1,
                    **kw)
    before = relax_multi.launches
    relax_multi(vals, parent, fro, [blk], k=2, **kw)
    assert relax_multi.launches == before

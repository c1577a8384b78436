"""The port's fixpoint engine and stability layer held against the JAX
reference, bit for bit: values, parents, iterations, edge_work and
unstable counts for all five semirings, from scratch, incremental, seeded
both ways, batched with padded lanes, and across fused_k: the engine's
own chunks (the default, ``fused_k=None``) equal the one-sweep loop
(``fused_k=1``) and a fixed ``fused_k`` the reference's fused loop."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.graph import engine as jeng  # noqa: E402
from repro.graph import stability as jstab  # noqa: E402
from repro.graph.edgeset import EdgeView as JView  # noqa: E402
from repro.graph.edgeset import make_block as j_make_block  # noqa: E402
from repro.graph.edgeset import stack_delta_blocks as j_stack  # noqa: E402
from repro.graph.edgeset import EdgeBlock as JBlock  # noqa: E402
from repro.graph.semiring import ALL_SEMIRINGS as JSEMI  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.graph import engine as teng  # noqa: E402
from repro_torch.graph import stability as tstab  # noqa: E402
from repro_torch.graph.edgeset import EdgeView as TView  # noqa: E402
from repro_torch.graph.edgeset import lane_bucket  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402
from repro_torch.kernels.edge_relax.ref import KERNEL_OP_FOR  # noqa: E402
from repro_torch.kernels.edge_relax_multi import relax_multi  # noqa: E402

SEMIRINGS = sorted(JSEMI)
N = 160


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _blk(jblk):
    """The JAX block's padded arrays as a port block (CPU)."""
    return interop.block_from_arrays(*(np.asarray(a) for a in jblk), "cpu")


def _assert_result(t, j, msg, unstable=False):
    np.testing.assert_array_equal(_np(t.values), np.asarray(j.values),
                                  err_msg=f"{msg}: values")
    np.testing.assert_array_equal(_np(t.parent), np.asarray(j.parent),
                                  err_msg=f"{msg}: parent")
    np.testing.assert_array_equal(_np(t.iterations), np.asarray(j.iterations),
                                  err_msg=f"{msg}: iterations")
    np.testing.assert_array_equal(_np(t.edge_work), np.asarray(j.edge_work),
                                  err_msg=f"{msg}: edge_work")
    if unstable:
        np.testing.assert_array_equal(_np(t.unstable), np.asarray(j.unstable),
                                      err_msg=f"{msg}: unstable")


def _edges(n, e, seed):
    rng = np.random.default_rng(seed)
    # a path from the source keeps most vertices reachable
    src = np.concatenate([np.arange(n - 1), rng.integers(0, n, e)])
    dst = np.concatenate([np.arange(1, n), rng.integers(0, n, e)])
    w = (rng.random(src.size) * 0.999 + 1e-3).astype(np.float32)
    return src.astype(np.int32), dst.astype(np.int32), w


@pytest.fixture(scope="module")
def graph():
    """A base graph split into two blocks plus three Δ batches."""
    src, dst, w = _edges(N, 900, 0)
    cut = src.size // 2
    base = [j_make_block(src[:cut], dst[:cut], w[:cut], N, granule=256),
            j_make_block(src[cut:], dst[cut:], w[cut:], N, granule=256)]
    deltas = []
    for i in range(3):
        s, d, ww = _edges(N, 60 + 40 * i, 10 + i)
        s, d, ww = s[N - 1:], d[N - 1:], ww[N - 1:]
        deltas.append((s, d, ww))
    return base, deltas


# -- from scratch -----------------------------------------------------------------


@pytest.mark.parametrize("name", SEMIRINGS)
def test_run_to_fixpoint_matches_reference(graph, name):
    base, _ = graph
    jv, tv = JView(tuple(base), N), TView(tuple(_blk(b) for b in base), N)
    for track in (True, False):
        j = jeng.run_to_fixpoint(jv, JSEMI[name], 0, track_parents=track)
        t = teng.run_to_fixpoint(tv, TSEMI[name], 0, track_parents=track)
        _assert_result(t, j, f"{name} track={track}")
    # a max_iters cap stops both mid-run at the same state
    j = jeng.run_to_fixpoint(jv, JSEMI[name], 0, max_iters=3)
    t = teng.run_to_fixpoint(tv, TSEMI[name], 0, max_iters=3)
    _assert_result(t, j, f"{name} max_iters=3")


@pytest.mark.parametrize("name", SEMIRINGS)
def test_run_to_fixpoint_invariant_in_fused_k(graph, name):
    """fused_k is a pure launch-shape knob: bit-identical to the reference
    at every chunk size, including a chunk cap that meets max_iters; the
    engine's own chunks (None: 4, 8, 16, ... sweeps) equal the one-sweep
    loop, with max_iters caps that land inside a chunk."""
    base, _ = graph
    jv, tv = JView(tuple(base), N), TView(tuple(_blk(b) for b in base), N)
    ref = jeng.run_to_fixpoint(jv, JSEMI[name], 0)
    for fk in (None, 2, 3, 7):
        t = teng.run_to_fixpoint(tv, TSEMI[name], 0, fused_k=fk)
        _assert_result(t, ref, f"{name} fused_k={fk}")
        for cap in (1, 5, 11):
            j = jeng.run_to_fixpoint(jv, JSEMI[name], 0, max_iters=cap,
                                     fused_k=fk or 1)
            t = teng.run_to_fixpoint(tv, TSEMI[name], 0, max_iters=cap,
                                     fused_k=fk)
            _assert_result(t, j, f"{name} fused_k={fk} max_iters={cap}")
            if fk is None:
                one = teng.run_to_fixpoint(tv, TSEMI[name], 0,
                                           max_iters=cap, fused_k=1)
                _assert_result(t, one, f"{name} max_iters={cap} vs k=1")


@pytest.mark.parametrize("name", SEMIRINGS)
def test_relax_sweep_and_fused_chunk_match_reference(graph, name):
    base, _ = graph
    jb, tb = tuple(base), tuple(_blk(b) for b in base)
    sr_j, sr_t = JSEMI[name], TSEMI[name]
    vals = jeng.init_values(N, sr_j, 0)
    par = jnp.full((N,), -1, jnp.int32)
    fro = jnp.zeros((N,), bool).at[0].set(True)
    tvals, tpar, tfro = (torch.from_numpy(np.array(a)) for a in
                         (vals, par, fro))
    # the port has no block gate; it equals the reference gated or not
    t = teng.relax_sweep(sr_t, N, tvals, tpar, tfro, tb)
    for gated in (False, True):
        j = jeng.relax_sweep(sr_j, N, vals, par, fro, jb, gated=gated)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
    j = jeng.relax_sweep_fused(sr_j, N, vals, par, fro, jb, k=4)
    t = teng.relax_sweep_fused(sr_t, N, tvals, tpar, tfro, tb, k=4)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# -- incremental and seeding --------------------------------------------------------------


@pytest.fixture(scope="module")
def anchors(graph):
    """Converged reference states on the base graph, per semiring."""
    base, _ = graph
    jv = JView(tuple(base), N)
    return {name: jeng.run_to_fixpoint(jv, JSEMI[name], 0)
            for name in SEMIRINGS}


@pytest.mark.parametrize("name", SEMIRINGS)
def test_seed_state_both_modes_match_reference(graph, anchors, name):
    _, deltas = graph
    a = anchors[name]
    jd = j_make_block(*deltas[0], N, granule=64)
    state = interop.state_from_arrays(a.values, a.parent, "cpu")
    for mode in ("instability", "delta"):
        j = jstab.seed_state(JSEMI[name], N, a.values, a.parent, (jd,),
                             mode=mode)
        t = tstab.seed_state(TSEMI[name], N, state.values, state.parent,
                             (_blk(jd),), mode=mode)
        for field in ("values", "parent", "frontier", "seed_work", "unstable"):
            np.testing.assert_array_equal(
                _np(getattr(t, field)), np.asarray(getattr(j, field)),
                err_msg=f"{name} {mode} {field}")
    np.testing.assert_array_equal(
        _np(tstab.seed_mask(TSEMI[name], state.values)),
        np.asarray(jstab.seed_mask(JSEMI[name], a.values)))
    with pytest.raises(ValueError, match="seed mode"):
        tstab.seed_state(TSEMI[name], N, state.values, state.parent,
                         (_blk(jd),), mode="bogus")


@pytest.mark.parametrize("name", SEMIRINGS)
def test_incremental_additions_matches_reference(graph, anchors, name):
    base, deltas = graph
    a = anchors[name]
    state = interop.state_from_arrays(a.values, a.parent, "cpu")
    jd = j_make_block(*deltas[1], N, granule=64)
    jv = JView(tuple(base) + (jd,), N)
    tv = TView(tuple(_blk(b) for b in base) + (_blk(jd),), N)
    for seed in ("instability", "delta"):
        for fk in (None, 1, 3):
            j = jeng.incremental_additions(jv, jd, JSEMI[name], a.values,
                                           a.parent, seed=seed,
                                           fused_k=fk or 1)
            t = teng.incremental_additions(tv, _blk(jd), TSEMI[name],
                                           state.values, state.parent,
                                           seed=seed, fused_k=fk)
            _assert_result(t, j, f"{name} seed={seed} fused_k={fk}",
                           unstable=True)


@pytest.mark.parametrize("name", SEMIRINGS)
def test_incremental_additions_batched_with_padded_lanes(graph, anchors, name):
    """Three Δ lanes bucketed to four (one masked lane), stopping at
    different sweeps: every lane's values, parents, iterations, edge_work
    and unstable equal the reference's batched launch, the engine's own
    chunks (None) its one-sweep loop, also under a max_iters cap."""
    base, deltas = graph
    a = anchors[name]
    bucket = lane_bucket(len(deltas))
    jstack = j_stack(deltas, N, granule=64, num_lanes=bucket)
    valid = np.arange(bucket) < len(deltas)
    jvals = jnp.broadcast_to(a.values, (bucket, N))
    jpar = jnp.broadcast_to(a.parent, (bucket, N))
    tvals, tpar = teng.gather_lane_states(
        *interop.state_from_arrays(np.asarray(a.values)[None],
                                   np.asarray(a.parent)[None], "cpu"),
        [0] * bucket)
    stops = set()
    for track, fk, cap in ((True, 1, 10_000), (False, 2, 10_000),
                           (True, None, 10_000), (False, None, 10_000),
                           (True, None, 6)):
        j = jeng.incremental_additions_batched(
            N, JSEMI[name], jvals, jpar, tuple(base), (jstack,),
            max_iters=cap, track_parents=track,
            lane_valid=jnp.asarray(valid), fused_k=fk or 1)
        t = teng.incremental_additions_batched(
            N, TSEMI[name], tvals, tpar, tuple(_blk(b) for b in base),
            (_blk(jstack),), max_iters=cap, track_parents=track,
            lane_valid=torch.from_numpy(valid), fused_k=fk)
        _assert_result(t, j, f"{name} track={track} fused_k={fk} "
                       f"max_iters={cap}", unstable=True)
        assert int(t.iterations[-1]) == 0 and float(t.edge_work[-1]) == 0.0
        if cap == 10_000:
            stops.add(tuple(t.iterations[:len(deltas)].tolist()))
    assert len(stops) == 1 and len(set(stops.pop())) > 1


@pytest.mark.parametrize("name", SEMIRINGS)
def test_relax_multi_adds_each_sweep_to_the_running_total(name):
    """A chunk's work starts from the lane's running total and adds each
    sweep in turn, as the one-sweep loop does (``total + s_r``), not the
    chunk's sum: from 2^24 - 3, a chain's sweeps of one active edge each
    stop at 2^24 one at a time, where a chunk summed first would reach
    2^24 + 6. The same holds against the reference's one-sweep loop."""
    n, k = 12, 9
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    w = np.full(n - 1, 0.5, np.float32)
    sr_t, sr_j = TSEMI[name], JSEMI[name]
    start = np.float32(2 ** 24 - 3)
    block = tuple(torch.from_numpy(a) for a in (src, dst, w))
    values = teng.init_values(n, sr_t, 0, device="cpu")[None]
    parent = torch.full((1, n), -1, dtype=torch.int32)
    frontier = torch.zeros((1, n), dtype=torch.bool)
    frontier[0, 0] = True
    kw = dict(op=KERNEL_OP_FOR[name], num_nodes=n, track_parents=True)
    got = relax_multi(values, parent, frontier, [block], k=k,
                      work=torch.tensor([start]), **kw)
    one = (values, parent, frontier)
    total, sweeps = torch.tensor([start]), 0
    for _ in range(k):
        *one, s, dw = relax_multi(*one, [block], k=1, **kw)
        total, sweeps = total + dw, sweeps + int(s)
    summed = relax_multi(values, parent, frontier, [block], k=k, **kw)[4]
    assert int(got[3]) == sweeps == k
    for g, r in zip(got[:3], one):
        assert torch.equal(g, r)
    assert got[4].view(torch.int32).item() == total.view(torch.int32).item()
    assert float(got[4]) == 2.0 ** 24
    assert float(start + summed) == 2.0 ** 24 + 6
    # the reference engine's one-sweep loop, from the same total
    jb = JBlock(*(jnp.asarray(a) for a in (src, dst, w)))
    jv = jeng.init_values(n, sr_j, 0)
    jp = jnp.full((n,), -1, jnp.int32)
    jf = jnp.zeros((n,), bool).at[0].set(True)
    jtotal = jnp.float32(start)
    for _ in range(k):
        jv, jp, jf, dw = jeng.relax_sweep(sr_j, n, jv, jp, jf, (jb,))
        jtotal = jtotal + dw
    assert float(got[4][0]) == float(jtotal)
    np.testing.assert_array_equal(_np(got[0][0]), np.asarray(jv))


def test_stable_fraction_milli_matches_reference():
    counts = [3, 0, 17, 160]
    valid = [True, True, False, True]
    assert tstab.stable_fraction_milli(counts, N) == \
        jstab.stable_fraction_milli(counts, N)
    assert tstab.stable_fraction_milli(torch.tensor(counts), N,
                                       torch.tensor(valid)) == \
        jstab.stable_fraction_milli(np.array(counts), N, np.array(valid))
    assert tstab.stable_fraction_milli([], N) == 0


def test_query_state_and_host_sync():
    vals = torch.zeros(10)
    par = torch.full((10,), -1, dtype=torch.int32)
    res = teng.FixpointResult(vals, par, torch.tensor(1), torch.tensor(2.0))
    state = teng.extract_state(res)
    assert state.values is vals and state.nbytes == 80
    assert teng.host_sync(res) is res
    np.testing.assert_array_equal(
        _np(teng.init_values(5, TSEMI["sswp"], 2, device="cpu")),
        np.asarray(jeng.init_values(5, JSEMI["sswp"], 2)))


# -- denormals -------------------------------------------------------------------------------


def test_viterbi_chain_underflow_matches_reference():
    """A Viterbi chain whose products fall below FLT_MIN: the reference
    flushes them to zero (unreached), and so does the port."""
    n = 20
    src = np.arange(n - 1, dtype=np.int32)
    dst = np.arange(1, n, dtype=np.int32)
    w = np.full(n - 1, 1e-3, np.float32)
    jb = j_make_block(src, dst, w, n, granule=64)
    j = jeng.run_to_fixpoint(JView((jb,), n), JSEMI["viterbi"], 0)
    t = teng.run_to_fixpoint(TView((_blk(jb),), n), TSEMI["viterbi"], 0)
    _assert_result(t, j, "viterbi chain")
    vals = _np(t.values)
    assert vals[12] > 0.0 and vals[13] == 0.0   # 1e-39 is flushed
    assert vals[14:].max() == 0.0

"""The port's spans and counters (``repro_torch.runtime.trace``) on the CPU
at toy size: off they record nothing and open no profiler range; inside
``trace.recording()`` or under ``torch.profiler`` the engine's, the
executors' and the store's spans appear, nested; the engine's counters
equal what its results report; every result is bit-identical with
recording on and off; the benchmark's readers of ``totals()``.
"""

import contextlib
import importlib.util
import pathlib
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_inputs import edges, one_torch_thread  # noqa: E402,F401
from repro_torch.configs import commongraph as tcg  # noqa: E402
from repro_torch.core.directhop import run_direct_hop_batched  # noqa: E402
from repro_torch.core.snapshots import SnapshotStore  # noqa: E402
from repro_torch.core.trigrid import (  # noqa: E402
    optimal_plan,
    run_plan_batched,
)
from repro_torch.graph import engine, make_evolving_sequence  # noqa: E402
from repro_torch.graph.edgeset import EdgeBlock, EdgeView  # noqa: E402
from repro_torch.graph.semiring import SSSP  # noqa: E402
from repro_torch.graph.stability import seed_state  # noqa: E402
from repro_torch.kernels.edge_relax_multi.ref import (  # noqa: E402
    relax_multi_ref,
)
from repro_torch.launch.mesh import make_snapshot_mesh  # noqa: E402
from repro_torch.runtime import trace  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SMALL = "small_5x"
SMALL_SHAPE = dict(n_snapshots=5, n_nodes=1024, cg_edges=8192,
                   delta_edges=512)
MODES = ("recording", "profiler")


@pytest.fixture(autouse=True)
def clean_trace():
    """Each test starts and ends with nothing recorded."""
    trace.reset()
    yield
    trace.reset()


@pytest.fixture
def small(monkeypatch):
    """The CommonGraph cell's small shape, registered."""
    monkeypatch.setitem(tcg.COMMONGRAPH_SHAPES, SMALL, dict(SMALL_SHAPE))
    return SMALL


@pytest.fixture
def ranges(monkeypatch):
    """The names of every profiler range opened: the spans' own and any
    ``torch.profiler.record_function``."""
    opened = []

    def counted(real):
        def open_range(name, *args, **kwargs):
            opened.append(name)
            return real(name, *args, **kwargs)
        return open_range

    monkeypatch.setattr(trace, "_range", counted(trace._range))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counted(torch.profiler.record_function))
    return opened


def recording_on(mode):
    """Turn recording on: ``trace.recording()`` or a CPU profiler."""
    if mode == "recording":
        return trace.recording()
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _store(seed=3):
    seq = make_evolving_sequence(300, 2000, 5, 100, seed=seed)
    return SnapshotStore(seq, device="cpu")


def _block(src, dst, w):
    return EdgeBlock(*(torch.from_numpy(np.ascontiguousarray(a))
                       for a in (src, dst, w)))


def _stacked_launch(n=200, lanes=3, bucket=4):
    """A warm state over a shared block and a stacked Δ of ``lanes``
    valid lanes padded to ``bucket`` with all-sentinel lanes."""
    shared = _block(*edges(n, 1200, 5, pad=40))
    rows = [edges(n, 90, 11 + lane, pad=10) for lane in range(lanes)]
    sentinel = (np.zeros(100, np.int32), np.full(100, n, np.int32),
                np.zeros(100, np.float32))
    rows += [sentinel] * (bucket - lanes)
    delta = _block(*(np.stack([r[i] for r in rows]) for i in range(3)))
    start = engine.run_to_fixpoint(EdgeView((shared,), n), SSSP, 0)
    values = start.values.expand(bucket, n).contiguous()
    parent = start.parent.expand(bucket, n).contiguous()
    lane_valid = torch.arange(bucket) < lanes
    return n, values, parent, shared, delta, lane_valid


def test_off_records_nothing_and_opens_no_range(ranges):
    """Off, spans and host and device counters record nothing, no profiler
    range opens and a span is the one shared no-op context."""
    store = _store()
    run_direct_hop_batched(store, SSSP, 0)
    run_plan_batched(store, optimal_plan(store), SSSP, 0)
    trace.count("probe", 3)
    trace.add("probe.sum", torch.tensor(5))
    assert not trace.active()
    assert trace.span("probe") is trace.span("other")
    assert trace.totals() == {"spans": {}, "counts": {}}
    assert ranges == []


def test_profiler_is_detected_by_its_python_flag(ranges):
    """The profiler's own Python flag, set exactly while it records,
    turns recording on: a torch that drops the flag or stops setting it
    fails here."""
    flag = torch.autograd.profiler
    assert not trace.active() and flag._is_profiler_enabled is False
    with recording_on("profiler"):
        assert trace.active() and flag._is_profiler_enabled is True
        assert torch.autograd._profiler_enabled()
        with trace.span("probe"):
            trace.count("probe")
    assert not trace.active() and flag._is_profiler_enabled is False
    assert ranges == ["probe"]
    got = trace.totals()
    assert got["spans"]["probe"]["count"] == 1
    assert got["counts"] == {"probe": 1}


@pytest.mark.parametrize("mode", MODES)
def test_program_spans_appear_nested(mode, ranges):
    """A cold Direct-Hop run records the executors', the engine's and the
    store's spans; ``engine.launch`` and ``engine.flag_read`` are
    ``engine.fixpoint``'s children (its self time is its total less
    theirs) and, under the profiler, ranges inside its ranges."""
    store = _store()
    with recording_on(mode) as prof:
        run_direct_hop_batched(store, SSSP, 0)
    spans = trace.totals()["spans"]
    assert {"fixpoint", "engine.fixpoint", "engine.launch",
            "engine.flag_read", "engine.seed", "host.sync", "hop.level",
            "hop.lane_gather", "hop.stats", "store.window_keys",
            "store.delta_keys", "store.block"} <= set(spans)
    fix = spans["engine.fixpoint"]
    assert fix["count"] == 2             # the common graph's, the hop's
    children = (spans["engine.launch"]["total_s"]
                + spans["engine.flag_read"]["total_s"])
    assert fix["self_s"] == pytest.approx(fix["total_s"] - children,
                                          abs=1e-6)
    assert spans["fixpoint"]["self_s"] < spans["fixpoint"]["total_s"]
    if mode == "recording":
        assert ranges == []
        return
    assert len(ranges) == sum(s["count"] for s in spans.values())
    events = [e for e in prof.events() if e.name in spans]
    assert {e.name for e in events} == set(spans)
    assert len(events) == len(ranges)
    outer = [e.time_range for e in events if e.name == "engine.fixpoint"]
    for e in events:
        if e.name in ("engine.launch", "engine.flag_read"):
            assert any(o.start <= e.time_range.start
                       and e.time_range.end <= o.end for o in outer)


@pytest.mark.parametrize("fused_k", [1, 4, None])
def test_rounds_are_flag_reads(fused_k, monkeypatch):
    """``engine.rounds`` counts ``_live_flags`` calls; at ``fused_k=1`` a
    fixpoint reads sweeps + 1 flags, fused chunks read fewer, the
    engine's own chunks (None: 4, 8, 16, ...) about log2 of the sweeps;
    ``engine.sweeps`` is its iterations, and ``engine.launched_sweeps``,
    the chunks' lengths, at least that."""
    calls = []
    real = engine._live_flags

    def counted(lives):
        calls.append(len(lives))
        return real(lives)

    monkeypatch.setattr(engine, "_live_flags", counted)
    view = EdgeView((_block(*edges(200, 1500, 5, pad=24)),), 200)
    with trace.recording():
        res = engine.run_to_fixpoint(view, SSSP, 0, fused_k=fused_k)
    counts = trace.totals()["counts"]
    sweeps = int(res.iterations)
    assert sweeps > 4
    assert counts["engine.rounds"] == len(calls)
    assert counts["engine.sweeps"] == sweeps
    assert counts["engine.active_edges"] == int(res.edge_work)
    launched = counts["engine.launched_sweeps"]
    assert launched >= sweeps
    if fused_k == 1:
        assert counts["engine.rounds"] == sweeps + 1
        assert launched == sweeps
    elif fused_k is None:
        chunks, want = 0, 0
        while want < sweeps:
            want += engine._chunk_sweeps(None, want, 10_000)
            chunks += 1
        assert counts["engine.rounds"] == chunks + 1 <= sweeps // 2 + 1
        assert launched == want
    else:
        assert counts["engine.rounds"] <= sweeps // fused_k + 2
        assert launched == fused_k * (counts["engine.rounds"] - 1)


def test_active_edges_are_edge_work_less_the_seed():
    """``engine.active_edges`` is the lanes' summed ``edge_work`` less the
    seed's work."""
    n, values, parent, shared, delta, lane_valid = _stacked_launch()
    with trace.recording():
        res = engine.incremental_additions_batched(
            n, SSSP, values, parent, (shared,), (delta,),
            lane_valid=lane_valid)
    seeded = seed_state(SSSP, n, values, parent, (delta,))
    seed_work = torch.where(lane_valid, seeded.seed_work, 0.0)
    want = int(res.edge_work.sum()) - int(seed_work.sum())
    assert want > 0
    assert trace.totals()["counts"]["engine.active_edges"] == want


def test_attempted_edges_are_real_edges_times_lane_sweeps():
    """``engine.attempted_edges`` is each lane's real edges (shared and
    its stacked row, padding slots and padding lanes left out) times the
    sweeps it ran; ``engine.sweeps`` is the most a lane ran."""
    n, values, parent, shared, delta, lane_valid = _stacked_launch()
    with trace.recording():
        res = engine.incremental_additions_batched(
            n, SSSP, values, parent, (shared,), (delta,),
            lane_valid=lane_valid)
    real = (int((shared.dst < n).sum())
            + (delta.dst < n).sum(1).numpy().astype(np.int64))
    assert list(real[3:]) == [int((shared.dst < n).sum())]
    # the engine's iterations count the seed as one
    sweeps = np.where(lane_valid.numpy(), res.iterations.numpy() - 1, 0)
    assert sweeps[:3].min() > 0
    counts = trace.totals()["counts"]
    assert counts["engine.attempted_edges"] == int((real * sweeps).sum())
    assert counts["engine.sweeps"] == int(sweeps.max())


@pytest.mark.parametrize("launch", ("fixpoint", "batched"))
def test_finish_visit_counters_add_up_over_chunks(monkeypatch, launch):
    """``relax.finish_visited`` and ``relax.finish_entries`` are the sums,
    over a fixpoint's chunks, of the visit counts the plain version
    reckons for each chunk on its own (a chunk's first round counts in
    neither); off, the engine asks the kernel for no counts."""
    real = engine.relax_multi
    chunks = []

    def counted(values, parent, frontier, blocks, allowed=None, **kw):
        want = torch.zeros(2, dtype=torch.int64)
        relax_multi_ref(values, parent, frontier, blocks, allowed,
                        **{**kw, "visits": want})
        chunks.append((kw.get("visits") is not None, kw["k"], want))
        return real(values, parent, frontier, blocks, allowed, **kw)

    monkeypatch.setattr(engine, "relax_multi", counted)

    def run():
        if launch == "fixpoint":
            view = EdgeView((_block(*edges(200, 1500, 5, pad=24)),), 200)
            return engine.run_to_fixpoint(view, SSSP, 0, fused_k=None)
        n, values, parent, shared, delta, lane_valid = _stacked_launch()
        return engine.incremental_additions_batched(
            n, SSSP, values, parent, (shared,), (delta,),
            lane_valid=lane_valid)

    run()
    assert chunks and not any(asked for asked, _, _ in chunks)
    chunks.clear()
    with trace.recording():
        run()
    counts = trace.totals()["counts"]
    fixpoint = [(k, want) for asked, k, want in chunks if asked]
    assert len(fixpoint) >= 2 and max(k for k, _ in fixpoint) > 1
    visited = sum(int(want[0]) for _, want in fixpoint)
    entries = sum(int(want[1]) for _, want in fixpoint)
    assert 0 < visited < entries
    assert counts["relax.finish_visited"] == visited
    assert counts["relax.finish_entries"] == entries


def test_real_edges_are_reckoned_once_a_block():
    """A block's real-edge count is reckoned on its first recorded
    fixpoint and kept while the block lives: a second fixpoint over it
    reads the kept count, a block of the same edges is counted anew, and
    a block that dies leaves nothing behind."""
    src, dst, w = edges(200, 1500, 5, pad=24)
    block = _block(src, dst, w)
    view = EdgeView((block,), 200)
    real = int((block.dst < 200).sum())
    with trace.recording():
        res = engine.run_to_fixpoint(view, SSSP, 0)
    sweeps = int(res.iterations)
    assert trace.totals()["counts"]["engine.attempted_edges"] \
        == real * sweeps
    assert int(engine._REAL_EDGES[block.dst][1]) == real
    kept = len(engine._REAL_EDGES)
    engine._REAL_EDGES[block.dst] = (200, torch.tensor(1, dtype=torch.int64))
    trace.reset()
    with trace.recording():
        engine.run_to_fixpoint(view, SSSP, 0)
    assert trace.totals()["counts"]["engine.attempted_edges"] == sweeps
    trace.reset()
    with trace.recording():
        engine.run_to_fixpoint(EdgeView((_block(src, dst, w),), 200),
                               SSSP, 0)
    assert trace.totals()["counts"]["engine.attempted_edges"] \
        == real * sweeps
    assert len(engine._REAL_EDGES) == kept
    del view, block
    assert len(engine._REAL_EDGES) == kept - 1


def _run(executor, small_shape=None):
    """One run of ``executor`` on a fresh toy input, as tensors."""
    if executor == "cell":
        inputs = tcg.commongraph_inputs(small_shape, seed=0, device="cpu")
        return list(tcg.make_commongraph_cell(small_shape).fn(*inputs))
    store = _store()
    if executor == "plan":
        run = run_plan_batched(store, optimal_plan(store), SSSP, 0,
                               track_parents=True)
        values = [run.results[i] for i in sorted(run.results)]
    else:
        run = run_direct_hop_batched(store, SSSP, 0, track_parents=True)
        values = list(run.results)
    stats = [run.base_stats] + list(run.hop_stats)
    return values + [torch.tensor([[s.edge_work, s.sweeps] for s in stats])]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("executor", ["plan", "direct_hop", "cell"])
def test_results_bit_identical_on_and_off(executor, mode, small):
    """``run_plan_batched``, ``run_direct_hop_batched`` and the cell's
    step return the same bits, work and iterations with recording on."""
    off = _run(executor, small)
    with recording_on(mode):
        on = _run(executor, small)
    assert len(on) == len(off)
    for got, want in zip(on, off):
        assert got.dtype == want.dtype and torch.equal(got, want)
    spans = trace.totals()["spans"]
    assert ("cell.step" in spans) == (executor == "cell")
    assert ("plan.dp" in spans) == (executor == "plan")


def test_sharded_launch_spans_and_counters(small):
    """On a CPU mesh the split, replica and gather spans appear, and the
    engine's rounds, sweeps and edge counters equal the unmeshed run's."""
    store = _store()
    with trace.recording():
        plain = run_direct_hop_batched(store, SSSP, 0)
    want = trace.totals()
    trace.reset()
    with trace.recording():
        meshed = run_direct_hop_batched(
            store, SSSP, 0, mesh=make_snapshot_mesh(["cpu"] * 4))
    got = trace.totals()
    for a, b in zip(meshed.results, plain.results):
        assert torch.equal(a, b)
    shard = {"shard.split", "shard.replicas", "shard.gather"}
    assert shard <= set(got["spans"]) and not shard & set(want["spans"])
    for name in ("engine.rounds", "engine.sweeps", "engine.active_edges",
                 "engine.attempted_edges"):
        assert got["counts"][name] == want["counts"][name], name
    trace.reset()
    inputs = tcg.commongraph_inputs(small, extent=2, seed=0, device="cpu")
    with trace.recording():
        cell = tcg.make_commongraph_cell(small, make_snapshot_mesh(
            ["cpu"] * 2))
        cell.fn(*inputs)
    assert shard | {"cell.step"} <= set(trace.totals()["spans"])


def test_reset_clears_and_recording_nests():
    """``reset`` forgets spans, counters and kept tensors; ``recording``
    nests and keeps what it recorded after it ends."""
    with trace.recording():
        with trace.recording():
            with trace.span("outer"):
                with trace.span("inner"):
                    trace.count("c", 2)
                    trace.add("s", torch.tensor(7, dtype=torch.int32))
                    trace.add("s", torch.tensor(5))
        assert trace.active()
    assert not trace.active()
    got = trace.totals()
    assert set(got["spans"]) == {"outer", "inner"}
    assert got["spans"]["outer"]["self_s"] <= got["spans"]["outer"]["total_s"]
    assert got["counts"] == {"c": 2, "s": 12}
    trace.reset()
    assert trace.totals() == {"spans": {}, "counts": {}}


@pytest.mark.parametrize("mode", MODES)
def test_device_span_counts_nanoseconds(mode):
    """Off, a device span is the shared no-op and records nothing; on a
    CPU device it adds the host clock's nanoseconds inside it to its
    counter, span after span, and keeps no events; ``reset`` clears it."""
    assert trace.device_span("probe_ns", "cpu") is trace.span("probe")
    with trace.device_span("probe_ns", "cpu"):
        pass
    assert trace.totals() == {"spans": {}, "counts": {}}
    with recording_on(mode):
        with trace.span("outer"):
            for _ in range(2):
                with trace.device_span("probe_ns", torch.device("cpu")):
                    time.sleep(0.002)
    got = trace.totals()
    assert 4_000_000 <= got["counts"]["probe_ns"] \
        <= 1e9 * got["spans"]["outer"]["total_s"]
    assert trace._events == {}
    trace.reset()
    assert trace.totals() == {"spans": {}, "counts": {}}


def test_add_keeps_tensors_and_totals_sums_them(monkeypatch):
    """``add`` keeps the tensor itself (no copy, no operation); past the
    fold limit the kept tensors are summed into one; ``totals`` sums
    every element as int64, float work and int32 iterations alike."""
    monkeypatch.setattr(trace, "_FOLD", 3)
    work = torch.tensor([3.0, 2.0**40, 5.0])
    with trace.recording():
        trace.add("w", work)
        [kept] = trace._kept[("w", work.device)]
        assert kept.data_ptr() == work.data_ptr()
        for i in range(7):
            trace.add("i", torch.tensor([i, 2**31 - 1], dtype=torch.int32))
    assert len(trace._kept[("i", work.device)]) <= 4
    assert trace.totals()["counts"] == {
        "w": 8 + 2**40, "i": 21 + 7 * (2**31 - 1)}


TOTALS = dict(
    spans={"engine.launch": dict(count=40, total_s=0.003, self_s=0.002),
           "engine.flag_read": dict(count=42, total_s=0.0085,
                                    self_s=0.0085),
           "cell.step": dict(count=4, total_s=0.4, self_s=0.01)},
    counts={"engine.rounds": 42, "engine.sweeps": 40,
            "engine.launched_sweeps": 50,
            "engine.active_edges": 1500, "engine.attempted_edges": 6000,
            "shard.copied_bytes": 4 * 192 * 2**20,
            "shard.broadcast_device_ns": 4 * 500_000,
            "engine.shard_rounds": 400, "engine.idle_shard_rounds": 20,
            "relax.finish_visited": 300, "relax.finish_entries": 4000})
ZERO = dict(
    spans={"engine.launch": dict(count=0, total_s=0.0, self_s=0.0),
           "engine.flag_read": dict(count=0, total_s=0.0, self_s=0.0),
           "cell.step": dict(count=0, total_s=0.0, self_s=0.0)},
    counts={"engine.rounds": 0, "engine.sweeps": 0,
            "engine.launched_sweeps": 0,
            "engine.active_edges": 0, "engine.attempted_edges": 0,
            "shard.copied_bytes": 0, "shard.broadcast_device_ns": 0,
            "engine.shard_rounds": 0, "engine.idle_shard_rounds": 0,
            "relax.finish_visited": 0, "relax.finish_entries": 0})


def _metric(name):
    path = REPO / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,want", [
    ("flag_reads_per_sweep", 1.05),
    ("round_launch_us", 50.0),
    ("round_host_us", 250.0),
    ("active_edge_pct", 25.0),
    ("dead_sweep_pct", 20.0),
    ("xcard_mib_per_step", 192.0),
    ("shard_exchange_ms", 0.5),
    ("idle_shard_pct", 5.0),
    ("finish_visit_pct", 7.5),
])
def test_metric_reads_the_program_totals(name, want, monkeypatch):
    """Each of the benchmark's readers of ``trace.totals()`` reads
    its value from a hand-made total, and None where a total is zero,
    where nothing was recorded or where the program has no trace
    module."""
    metric = _metric(name)
    for totals, value in ((TOTALS, want), (ZERO, None),
                          ({"spans": {}, "counts": {}}, None)):
        monkeypatch.setattr(trace, "totals", lambda totals=totals: totals)
        got = metric.read({})
        assert got == (None if value is None else pytest.approx(value))
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.trace", None)
    with contextlib.suppress(AttributeError):
        monkeypatch.delattr(sys.modules["repro_torch.runtime"], "trace")
    assert metric.read({}) is None

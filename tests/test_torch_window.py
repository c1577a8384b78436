"""The port's sliding-window executors (``repro_torch.core.window``) and the
store methods under them, held against the JAX package bit for bit.

Counterparts of tests/test_window.py (all but its two mesh tests): the
batched slide equals the sequential one and both equal the reference's
runs (values, parents where tracked, per-hop edge work and sweeps,
``added_edges``, ``lane_layout``, ``stable_milli``), run ungated and gated;
the store's LRU byte accounting and evictions equal the reference's. Also:
the committed ``BENCH_window_slide`` smoke baseline reproduced, a cached
Δ hop that skips ``delta_keys``, results that survive a second run, the
evolve CLI's window flags and the port-side window example on the CPU.
"""

import json
import pathlib
import runpy
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core import window as jwindow  # noqa: E402
from repro.core.snapshots import _block_nbytes as j_nbytes  # noqa: E402
from repro.graph import make_evolving_sequence  # noqa: E402
from repro.graph.engine import extract_state as j_extract  # noqa: E402
from repro.graph.semiring import ALL_SEMIRINGS as JSEMI  # noqa: E402
from _torch_inputs import one_torch_thread  # noqa: E402,F401
from repro_torch import core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import window as twindow  # noqa: E402
from repro_torch.core.snapshots import _block_nbytes as t_nbytes  # noqa: E402
from repro_torch.graph import EdgeView, run_to_fixpoint  # noqa: E402
from repro_torch.graph.engine import extract_state as t_extract  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SEMIRINGS = sorted(JSEMI)
SLIDE_FIELDS = ("lanes", "added_edges", "edge_work")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _stores(n=300, e=2400, snaps=6, changes=150, seed=11, granule=128,
            **kw):
    """The same evolving sequence in a reference store and a port store
    (CPU)."""
    seq = make_evolving_sequence(n, e, snaps, changes, seed=seed)
    tseq = interop.sequence_from_arrays(seq.num_nodes, seq.snapshot_keys,
                                        seq.additions, seq.deletions,
                                        seq.weight_seed)
    return (jcore.SnapshotStore(seq, granule=granule, **kw),
            tcore.SnapshotStore(tseq, granule=granule, device="cpu", **kw))


def _same(t, j, msg):
    np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=msg)


def _assert_slide(t, j, msg):
    """A port WindowSlideRun equals the reference's, bit for bit."""
    assert list(t.results) == list(j.results), msg
    for wnd in j.results:
        _same(t.results[wnd], j.results[wnd], f"{msg} {wnd}")
    assert t.anchor == j.anchor, msg
    assert (t.base_stats.edge_work, t.base_stats.sweeps) == \
        (j.base_stats.edge_work, j.base_stats.sweeps), msg
    assert [(s.edge_work, s.sweeps) for s in t.hop_stats] == \
        [(s.edge_work, s.sweeps) for s in j.hop_stats], msg
    assert t.added_edges == j.added_edges, msg
    assert t.lane_layout == j.lane_layout, msg
    assert t.stable_milli == j.stable_milli, msg


# -- window plan construction -------------------------------------------------

def test_slide_windows_construction():
    for args, kw in (((6, 3), {}), ((6, 3), {"step": 2}),
                     ((6, 3), {"start": 2}), ((6, 1), {}), ((6, 6), {})):
        assert tcore.slide_windows(*args, **kw) == \
            jcore.slide_windows(*args, **kw)
    assert tcore.slide_windows(6, 6) == [(0, 5)]
    for args, kw in (((6, 7), {}), ((6, 0), {}), ((6, 3), {"step": 0})):
        with pytest.raises(ValueError):
            tcore.slide_windows(*args, **kw)


def test_window_anchor_is_span():
    for windows in ([(1, 3), (2, 4), (3, 5)], [(2, 2)]):
        assert tcore.window_anchor(windows) == jcore.window_anchor(windows)
    with pytest.raises(ValueError):
        tcore.window_anchor([])


# -- batched-vs-sequential equivalence, held against the reference -----------

@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_window_slide_batched_identical_and_exact(name, track):
    """Batched == sequential in the port, both == the reference's runs
    (ungated and gated), every window == its from-scratch fixpoint."""
    js, ts = _stores()
    jsr, tsr = JSEMI[name], TSEMI[name]
    width = 3
    kw = {"track_parents": track}
    t_seq = tcore.run_window_slide(ts, tsr, 0, width, **kw)
    t_bat = tcore.run_window_slide_batched(ts, tsr, 0, width, **kw)
    windows = tcore.slide_windows(6, width)
    assert list(t_seq.results) == list(t_bat.results) == windows
    for wnd in windows:
        _same(t_bat.results[wnd], _np(t_seq.results[wnd]),
              f"{name} {wnd}: batched != sequential")
        ref = run_to_fixpoint(
            EdgeView((ts.window_block(*wnd),), ts.num_nodes), tsr, 0)
        np.testing.assert_allclose(_np(t_bat.results[wnd]), _np(ref.values),
                                   rtol=1e-6, err_msg=f"{name} {wnd} scratch")
    assert sum(s.edge_work for s in t_seq.hop_stats) == \
        sum(s.edge_work for s in t_bat.hop_stats)
    _assert_slide(t_seq, jcore.run_window_slide(js, jsr, 0, width, **kw),
                  f"{name} seq")
    _assert_slide(t_bat, jcore.run_window_slide_batched(js, jsr, 0, width,
                                                        **kw),
                  f"{name} batched")
    _assert_slide(t_bat, jcore.run_window_slide_batched(
        js, jsr, 0, width, gated=True, **kw), f"{name} batched gated")


@pytest.mark.parametrize("name", ["sssp", "viterbi"])
def test_slide_launch_parents_match_reference(name):
    """The stacked launch's per-lane values and parents (tracked), sweeps,
    work and unstable counts equal the reference's, masked lanes included."""
    js, ts = _stores(seed=5)
    windows = tcore.slide_windows(6, 2)           # 5 windows -> 8 lanes
    anchor = tcore.window_anchor(windows)
    view, base, _ = jcore.trigrid._anchor_base(js, anchor, JSEMI[name], 0,
                                               10_000, False, 1, True)
    jres, jbucket = jwindow._slide_launch(
        js, JSEMI[name], view, j_extract(base), windows, anchor,
        max_iters=10_000, gated=False, track_parents=True, mesh=None)
    view, base, _ = tcore.trigrid._anchor_base(ts, anchor, TSEMI[name], 0,
                                               10_000, 1, True)
    tres, tbucket = twindow._slide_launch(
        ts, TSEMI[name], view, t_extract(base), windows, anchor,
        max_iters=10_000, track_parents=True)
    assert tbucket == jbucket == 8
    for part in ("values", "parent", "iterations", "edge_work", "unstable"):
        _same(getattr(tres, part), getattr(jres, part), f"{name} {part}")


def test_window_slide_edge_work_parity():
    """Padding excluded from work: batched totals equal sequential totals,
    and both equal the reference's."""
    js, ts = _stores(seed=5)
    sr = TSEMI["sssp"]
    for width in (2, 3):
        seq_run = tcore.run_window_slide(ts, sr, 0, width, track_parents=True)
        bat_run = tcore.run_window_slide_batched(ts, sr, 0, width,
                                                 track_parents=True)
        seq_work = sum(h.edge_work for h in seq_run.hop_stats)
        assert seq_work == sum(h.edge_work for h in bat_run.hop_stats)
        ref = jcore.run_window_slide_batched(js, JSEMI["sssp"], 0, width,
                                             track_parents=True)
        assert seq_work == sum(h.edge_work for h in ref.hop_stats)


def test_window_slide_degenerate_single_window():
    """width == num_snapshots: one window == the anchor, empty Δ, the
    anchor state returned unchanged."""
    js, ts = _stores(snaps=4, seed=3)
    bat = tcore.run_window_slide_batched(ts, TSEMI["sssp"], 0, 4)
    assert list(bat.results) == [(0, 3)]
    assert bat.anchor == (0, 3) and bat.added_edges == 0
    ref = run_to_fixpoint(ts.common_graph_view(0, 3), TSEMI["sssp"], 0)
    _same(bat.results[(0, 3)], _np(ref.values), "degenerate")
    _assert_slide(bat, jcore.run_window_slide_batched(js, JSEMI["sssp"], 0,
                                                      4), "degenerate")


def test_window_slide_explicit_windows_and_anchor():
    """Non-contiguous windows + explicit anchor; an anchor that is not a
    super-window of every window raises."""
    js, ts = _stores(seed=19)
    windows = [(1, 2), (3, 4)]
    seq_run = tcore.run_window_slide(ts, TSEMI["sssp"], 0, windows=windows,
                                     anchor=(0, 5))
    bat_run = tcore.run_window_slide_batched(ts, TSEMI["sssp"], 0,
                                             windows=windows, anchor=(0, 5))
    for wnd in windows:
        _same(bat_run.results[wnd], _np(seq_run.results[wnd]), f"{wnd}")
    _assert_slide(seq_run, jcore.run_window_slide(
        js, JSEMI["sssp"], 0, windows=windows, anchor=(0, 5)), "explicit")
    with pytest.raises(ValueError):
        tcore.run_window_slide_batched(ts, TSEMI["sssp"], 0, windows=windows,
                                       anchor=(2, 5))


def test_window_slide_fused_k_matches_reference():
    """fused_k = 4 gives the reference's fused_k = 1 results and stats."""
    js, ts = _stores(seed=7)
    ref = jcore.run_window_slide_batched(js, JSEMI["sswp"], 0, 2)
    for runner in (tcore.run_window_slide, tcore.run_window_slide_batched):
        got = runner(ts, TSEMI["sswp"], 0, 2, fused_k=4)
        for wnd in ref.results:
            _same(got.results[wnd], ref.results[wnd], f"fused {wnd}")
        assert got.base_stats.sweeps == ref.base_stats.sweeps
        assert sum(s.edge_work for s in got.hop_stats) == \
            sum(s.edge_work for s in ref.hop_stats)


def test_batched_results_survive_a_second_run():
    """Per-window results are rows of one fresh [L, N] output: a second
    run (and a stream over the same windows) leaves them unchanged."""
    _, ts = _stores(seed=13)
    sr = TSEMI["bfs"]
    first = tcore.run_window_slide_batched(ts, sr, 0, 2)
    kept = {wnd: v.clone() for wnd, v in first.results.items()}
    tcore.run_window_slide_batched(ts, sr, 0, 2)
    tcore.run_window_stream_batched(ts, sr, 0, 2, campaign_width=2)
    for wnd, v in kept.items():
        _same(first.results[wnd], _np(v), f"{wnd} changed")


# -- store: slide blocks, the tag-first Δ lookup, LRU eviction ----------------

def _arrays(blk):
    return [_np(a) for a in blk]


def test_slide_block_and_stack_match_reference():
    js, ts = _stores(seed=7)
    windows = tcore.slide_windows(6, 2)
    for anchor in (None, (0, 5), (1, 5)):
        wnds = [w for w in windows if anchor is None or w[0] >= anchor[0]]
        for got, want in zip(_arrays(ts.slide_block(wnds[0], anchor)),
                             _arrays(js.slide_block(wnds[0], anchor))):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(_arrays(ts.slide_stack(wnds, anchor,
                                                    num_lanes=8)),
                             _arrays(js.slide_stack(wnds, anchor,
                                                    num_lanes=8))):
            np.testing.assert_array_equal(got, want)


def test_cached_delta_block_skips_delta_keys(monkeypatch):
    """A cached hop is served by its tag: ``delta_keys`` runs once per hop,
    and a warm sequential slide runs it zero times; blocks equal the
    reference's."""
    js, ts = _stores(seed=7)
    calls = []
    delta_keys = tcore.SnapshotStore.delta_keys

    def counted(self, parent, child):
        calls.append((parent, child))
        return delta_keys(self, parent, child)

    monkeypatch.setattr(tcore.SnapshotStore, "delta_keys", counted)
    blk = ts.delta_block((0, 5), (1, 2))
    assert calls == [((0, 5), (1, 2))]
    assert ts.delta_block((0, 5), (1, 2)) is blk
    assert len(calls) == 1
    for got, want in zip(_arrays(blk), _arrays(js.delta_block((0, 5),
                                                              (1, 2)))):
        np.testing.assert_array_equal(got, want)
    sr = TSEMI["sssp"]
    cold = tcore.run_window_slide(ts, sr, 0, 3)
    calls.clear()
    warm = tcore.run_window_slide(ts, sr, 0, 3)
    assert calls == []
    for wnd in cold.results:
        _same(warm.results[wnd], _np(cold.results[wnd]), f"{wnd}")


def test_store_lru_eviction_frees_delta_stacks():
    """A byte budget evicts least-recently-used blocks (delta stacks
    included), re-fetching rebuilds bit-identical arrays, and evictions and
    byte counts equal the reference store's."""
    _, unbounded = _stores(seed=7)
    first = _arrays(unbounded.slide_stack(tcore.slide_windows(6, 2),
                                          num_lanes=8))
    one_stack = t_nbytes(unbounded.slide_stack(tcore.slide_windows(6, 2),
                                               num_lanes=8))
    js, ts = _stores(seed=7, cache_bytes=one_stack)
    for store in (js, ts):
        store.slide_stack(tcore.slide_windows(6, 2), num_lanes=8)
        store.slide_stack(tcore.slide_windows(6, 3), num_lanes=4)
        store.slide_stack(tcore.slide_windows(6, 4), num_lanes=4)
    assert ts.evictions == js.evictions > 0
    assert ts.cached_nbytes == js.cached_nbytes
    assert list(ts._blocks) == list(js._blocks)
    rebuilt = _arrays(ts.slide_stack(tcore.slide_windows(6, 2), num_lanes=8))
    for x, y in zip(first, rebuilt):
        np.testing.assert_array_equal(x, y)


def test_store_lru_keeps_newest_block_even_over_budget():
    _, ts = _stores(seed=7, cache_bytes=1)
    blk = ts.slide_stack(tcore.slide_windows(6, 2), num_lanes=8)
    assert len(ts._blocks) == 1
    assert ts.slide_stack(tcore.slide_windows(6, 2), num_lanes=8) is blk


def test_store_explicit_release_by_family():
    js, ts = _stores(seed=7)
    freed = []
    for store in (js, ts):
        store.window_block(0, 5)
        store.delta_block((0, 5), (1, 2))
        store.slide_stack(tcore.slide_windows(6, 2), num_lanes=8)
        before = store.cached_nbytes
        freed.append(store.release(("DS",)))
        assert store.cached_nbytes == before - freed[-1]
        assert {t[0] for t in store._blocks} == {"T", "D"}
        freed.append(store.release())
        assert store.cached_nbytes == 0 and not store._blocks
    assert freed[:2] == freed[2:] and all(freed)


def test_cache_put_overwrite_subtracts_displaced_bytes():
    _, ts = _stores(seed=7)

    def actual():
        return sum(t_nbytes(b) for b in ts._blocks.values())

    for _ in range(3):
        ts.window_block(0, 5)
        blk = ts.slide_stack(tcore.slide_windows(6, 2), num_lanes=8)
        assert ts.cached_nbytes == actual()
        tag = next(t for t in ts._blocks if t[0] == "DS")
        before = ts.cached_nbytes
        ts._cache_put(tag, blk)
        assert ts.cached_nbytes == before == actual()
        ts.release(("DS",))
        assert ts.cached_nbytes == actual()
    ts.release()
    assert ts.cached_nbytes == 0


def test_window_slide_results_unchanged_under_eviction():
    """A memory-tight store (constant rebuilds) returns the unbounded
    store's results, with the reference's eviction count."""
    _, free = _stores(seed=13)
    jtight, tight = _stores(seed=13, cache_bytes=64 * 1024)
    for width in (2, 3):
        a = tcore.run_window_slide_batched(free, TSEMI["sssp"], 0, width)
        b = tcore.run_window_slide_batched(tight, TSEMI["sssp"], 0, width)
        jcore.run_window_slide_batched(jtight, JSEMI["sssp"], 0, width)
        for wnd in a.results:
            _same(b.results[wnd], _np(a.results[wnd]), f"{wnd}")
    assert tight.evictions == jtight.evictions > 0
    assert tight.cached_nbytes == jtight.cached_nbytes
    assert sum(j_nbytes(b) for b in jtight._blocks.values()) == \
        tight.cached_nbytes


# -- the committed smoke baseline, the CLI and the example --------------------

def _exact(bench):
    path = REPO / "benchmarks" / "baselines" / "smoke" / f"BENCH_{bench}.json"
    return {row["name"]: row["exact"]
            for row in json.loads(path.read_text())["rows"]}


def test_window_slide_reproduces_smoke_baseline():
    """``benchmarks.run``'s window_slide smoke cell (``SCALES``: widths (2,),
    6 snapshots, the bench's defaults n 10,000, e 100,000, 4,000 changes,
    seed 0, sssp from 0): lanes, added_edges and edge_work to the digit."""
    seq = make_evolving_sequence(10_000, 100_000, 6, 4_000, seed=0)
    store = tcore.SnapshotStore(interop.sequence_from_arrays(
        seq.num_nodes, seq.snapshot_keys, seq.additions, seq.deletions,
        seq.weight_seed), device="cpu")
    sr = TSEMI["sssp"]
    seq_run = tcore.run_window_slide(store, sr, 0, 2)
    bat_run = tcore.run_window_slide_batched(store, sr, 0, 2)
    for wnd in seq_run.results:
        _same(bat_run.results[wnd], _np(seq_run.results[wnd]), f"{wnd}")
    got = {"lanes": len(tcore.slide_windows(6, 2)),
           "added_edges": seq_run.added_edges,
           "edge_work": int(round(sum(h.edge_work
                                      for h in bat_run.hop_stats)))}
    assert got == {k: _exact("window_slide")["window_slide/width2"][k]
                   for k in SLIDE_FIELDS}


def test_evolve_window_flags_on_cpu(capsys):
    from repro_torch.launch import evolve
    summary = evolve.main(["--nodes", "300", "--edges", "2000",
                           "--snapshots", "5", "--changes", "120",
                           "--alg", "sssp", "--verify", "--device", "cpu",
                           "--window", "3", "--window-batch", "--stream",
                           "--campaign-width", "auto", "--fused-k", "4"])
    out = capsys.readouterr().out
    assert summary["verified"]
    win = summary["windows"]
    assert win["windows"] == [(0, 2), (1, 3), (2, 4)]
    assert set(win["wall_s"]) == {"slide", "batch", "stream", "cold"}
    assert win["stream"].plan is not None
    assert win["launches"] == {"edge_relax": 0, "edge_relax_multi": 0}
    assert set(summary["results"]) == set(evolve.MODES)
    for line in ("Window slide (seq):", "Window slide (batch):",
                 "Window stream:", "campaign plan (auto, lane_budget 8)",
                 "verify: window slide exact on every window (batched "
                 "bit-identical) (stream bit-identical to cold campaigns)"):
        assert line in out
    fixed = evolve.main(["--nodes", "300", "--edges", "2000", "--snapshots",
                         "5", "--changes", "120", "--device", "cpu",
                         "--window", "2", "--stream", "--campaign-width",
                         "2"])
    assert [len(c) for c in fixed["windows"]["stream"].campaigns] == [2, 2]
    assert fixed["windows"]["batch"] is None
    for bad in (["--window-batch"], ["--stream"], ["--window", "2",
                                                   "--fused-k", "0"],
                ["--window", "2", "--campaign-width", "0"]):
        with pytest.raises(SystemExit):
            evolve.main(["--device", "cpu", *bad])


def test_torch_multi_query_window_example(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "torch_multi_query_window.py", "--device", "cpu", "--nodes", "400",
        "--edges", "3000", "--snapshots", "6"])
    runpy.run_path(str(REPO / "examples" / "torch_multi_query_window.py"),
                   run_name="__main__")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(TSEMI)
    assert lines[-1].startswith("viterbi ") and lines[-1].endswith("✓")

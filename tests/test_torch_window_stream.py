"""The port's streaming campaigns and anchor-state cache
(``repro_torch.core.window``), held against the JAX package bit for bit.

Counterparts of tests/test_window_stream.py (all but its mesh test and
its two compaction tests, which need ingestion): the stream equals the
cold per-campaign slides in the port and the reference's stream (values,
anchor states with parents, campaigns, anchors, rebuild/hop/hit events,
per-launch edge work and sweeps, ``added_edges``, ``anchor_delta_edges``,
``lane_layout``, ``stable_milli``), run ungated and gated. The anchor-state
cache, the planner, the anchor chains and the stream smoke baselines are
in tests/test_torch_campaigns.py.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.core import window as jwindow  # noqa: E402
from repro.graph import make_evolving_sequence  # noqa: E402
from repro.graph.semiring import ALL_SEMIRINGS as JSEMI  # noqa: E402
from _torch_inputs import one_torch_thread  # noqa: E402,F401
from repro_torch import core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import window as twindow  # noqa: E402
from repro_torch.graph.engine import QueryState  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402

SEMIRINGS = sorted(JSEMI)
SNAPS = 8
PLAN_FIELDS = ("campaigns", "anchors", "lane_budget", "data_extent",
               "slide_edges", "anchor_edges", "padding_edges",
               "total_edges", "stable_milli")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _seq_pair(n, e, snaps, changes, seed):
    seq = make_evolving_sequence(n, e, snaps, changes, seed=seed)
    return seq, interop.sequence_from_arrays(
        seq.num_nodes, seq.snapshot_keys, seq.additions, seq.deletions,
        seq.weight_seed)


def _stores(n=300, e=2400, snaps=SNAPS, changes=150, seed=11, granule=128,
            **kw):
    """The same evolving sequence in a reference store and a port store
    (CPU)."""
    seq, tseq = _seq_pair(n, e, snaps, changes, seed)
    return (jcore.SnapshotStore(seq, granule=granule, **kw),
            tcore.SnapshotStore(tseq, granule=granule, device="cpu", **kw))


def _tstore(**kw):
    return _stores(**kw)[1]


def _tqkey(name, track=False):
    return twindow._stream_qkey(TSEMI[name], 0, 10_000, 1, track)


def _jqkey(name, track=False, gated=False):
    return jwindow._stream_qkey(JSEMI[name], 0, 10_000, gated, 1, track)


def _same(t, j, msg):
    np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=msg)


def _assert_plan(t, j, msg=""):
    for field in PLAN_FIELDS:
        assert getattr(t, field) == getattr(j, field), f"{msg} {field}"


def _assert_stream(t, j, msg):
    """A port WindowStreamRun equals the reference's, bit for bit."""
    assert list(t.results) == list(j.results), msg
    for wnd in j.results:
        _same(t.results[wnd], j.results[wnd], f"{msg} {wnd}")
    for field in ("campaigns", "anchors", "anchor_events", "added_edges",
                  "anchor_delta_edges", "lane_layout", "stable_milli"):
        assert getattr(t, field) == getattr(j, field), f"{msg} {field}"
    for field in ("anchor_stats", "hop_stats"):
        assert [(s.edge_work, s.sweeps) for s in getattr(t, field)] == \
            [(s.edge_work, s.sweeps) for s in getattr(j, field)], \
            f"{msg} {field}"
    assert (t.plan is None) == (j.plan is None), msg
    if t.plan is not None:
        _assert_plan(t.plan, j.plan, msg)


def _assert_anchor_states(ts, js, t_qkey, j_qkey, anchors, msg):
    """Cached anchor states (values and parents) equal the reference's."""
    for anchor in anchors:
        t, j = ts.anchor_state_get(t_qkey, anchor), \
            js.anchor_state_get(j_qkey, anchor)
        assert isinstance(t, QueryState), f"{msg} {anchor}"
        _same(t.values, j.values, f"{msg} {anchor} values")
        _same(t.parent, j.parent, f"{msg} {anchor} parent")


# -- stream plan construction and the WindowStream object ---------------------

def test_stream_campaigns_partition():
    windows = tcore.slide_windows(SNAPS, 3)
    for width in (2, 4, 10):
        assert tcore.stream_campaigns(windows, width) == \
            jcore.stream_campaigns(windows, width)
    assert tcore.stream_campaigns(windows, 2) == [windows[0:2], windows[2:4],
                                                  windows[4:6]]
    with pytest.raises(ValueError):
        tcore.stream_campaigns(windows, 0)


def test_window_stream_object_buffers_and_drains():
    ws = tcore.WindowStream(campaign_width=2)
    ws.extend([(0, 2), (1, 3)])
    assert ws.pending() == [(0, 2), (1, 3)]
    assert ws.take() == [(0, 2), (1, 3)]
    assert ws.pending() == []
    ws.extend([(2, 4), (3, 5)])
    assert ws.pending() == [(2, 4), (3, 5)]
    with pytest.raises(ValueError):
        ws.extend([(1, 4)])
    with pytest.raises(ValueError):
        tcore.WindowStream(campaign_width=0)
    with pytest.raises(ValueError):
        tcore.WindowStream(campaign_width=2, windows=[(2, 4), (0, 3)])


def test_window_stream_rejects_conflicting_inputs():
    ts = _tstore(snaps=4)
    sr = TSEMI["sssp"]
    with pytest.raises(ValueError):
        tcore.run_window_stream_batched(ts, sr, 0)
    with pytest.raises(ValueError):
        tcore.run_window_stream_batched(
            ts, sr, 0, 2, stream=tcore.WindowStream(campaign_width=1))
    with pytest.raises(ValueError):
        tcore.run_window_stream_batched(
            ts, sr, 0, campaign_width=8,
            stream=tcore.WindowStream(campaign_width=1))
    with pytest.raises(ValueError):
        tcore.run_window_stream_batched(ts, sr, 0, windows=[(2, 4), (0, 3)])


def test_window_stream_take_next_bounded_draw():
    ws = tcore.WindowStream(campaign_width=2,
                            windows=[(0, 2), (1, 3), (2, 4), (3, 5)])
    assert ws.take_next(0) == []
    assert ws.take_next(2) == [(0, 2), (1, 3)]
    assert ws.pending() == [(2, 4), (3, 5)]
    assert ws.take_next(5) == [(2, 4), (3, 5)]
    assert ws.take_next(1) == []
    ws.extend([(4, 6)])
    assert ws.take() == [(4, 6)]


class _Feed:
    """A duck-typed live window feed: hands out its windows a few per poll
    and records the floors the stream reports."""

    def __init__(self, windows, per_poll):
        self.windows, self.per_poll, self.floors = list(windows), per_poll, []

    def poll(self):
        born, self.windows = (self.windows[:self.per_poll],
                              self.windows[self.per_poll:])
        return born

    def advance_floor(self, lo):
        self.floors.append(lo)


def test_window_stream_feed_hook_matches_reference():
    """The ``feed`` hook polls before every draw and reports the oldest
    snapshot an unconsumed window needs, as the reference's does."""
    windows = tcore.slide_windows(SNAPS, 3)
    seen = []
    for module in (tcore, jcore):
        feed = _Feed(windows, per_poll=2)
        ws = module.WindowStream(campaign_width=2, feed=feed)
        draws = [ws.take_next(1), ws.pending(), ws.take(), ws.take_next(3)]
        seen.append((draws, feed.floors, ws.consumed))
    assert seen[0] == seen[1]


def test_window_stream_empty_pending_is_noop():
    run = tcore.run_window_stream_batched(
        _tstore(snaps=4), TSEMI["sssp"], 0,
        stream=tcore.WindowStream(campaign_width=2))
    assert run.results == {} and run.campaigns == []
    assert run.anchor_rebuilds == 0


# -- bit-identity vs cold campaigns and vs the reference ----------------------

@pytest.mark.parametrize("track", [False, True])
@pytest.mark.parametrize("name", SEMIRINGS)
def test_window_stream_identical_to_cold_campaigns(name, track):
    """Stream == cold per-campaign slides in the port, with 1 rebuild +
    K-1 hops; stream == the reference's stream, anchor states included
    (gated too, for sssp)."""
    js, ts = _stores()
    tsr, jsr = TSEMI[name], JSEMI[name]
    run = tcore.run_window_stream_batched(ts, tsr, 0, 3, campaign_width=2,
                                          track_parents=track)
    assert len(run.campaigns) == 3
    assert run.anchor_events == ["rebuild", "hop", "hop"]
    cold_store = _tstore()
    for campaign, anchor in zip(run.campaigns, run.anchors):
        cold = tcore.run_window_slide_batched(cold_store, tsr, 0,
                                              windows=campaign, anchor=anchor,
                                              track_parents=track)
        for wnd in campaign:
            _same(run.results[wnd], _np(cold.results[wnd]),
                  f"{name} {wnd}: stream != cold campaign")
    ref = jcore.run_window_stream_batched(js, jsr, 0, 3, campaign_width=2,
                                          track_parents=track)
    _assert_stream(run, ref, name)
    _assert_anchor_states(ts, js, _tqkey(name, track), _jqkey(name, track),
                          run.anchors, name)
    if name == "sssp" and not track:
        gated = jcore.run_window_stream_batched(
            js, jsr, 0, 3, campaign_width=2, track_parents=track, gated=True)
        ts.release(("AS",))
        _assert_stream(tcore.run_window_stream_batched(
            ts, tsr, 0, 3, campaign_width=2, track_parents=track), gated,
            f"{name} gated")


def test_window_stream_campaign_launch_work_parity():
    """Given the same anchor state, a campaign's stacked launch does
    exactly the cold launch's edge work."""
    sr = TSEMI["sssp"]
    run = tcore.run_window_stream_batched(_tstore(seed=5), sr, 0, 2,
                                          campaign_width=2)
    cold_store = _tstore(seed=5)
    for campaign, anchor, hop in zip(run.campaigns, run.anchors,
                                     run.hop_stats):
        cold = tcore.run_window_slide_batched(cold_store, sr, 0,
                                              windows=campaign, anchor=anchor)
        assert hop.edge_work == sum(s.edge_work for s in cold.hop_stats)


def test_window_stream_matches_plain_slide_values():
    sr = TSEMI["sssp"]
    ts = _tstore(seed=23)
    slide = tcore.run_window_slide_batched(ts, sr, 0, 3)
    stream = tcore.run_window_stream_batched(ts, sr, 0, 3, campaign_width=2)
    assert list(stream.results) == list(slide.results)
    for wnd in slide.results:
        _same(stream.results[wnd], _np(slide.results[wnd]), f"{wnd}")


def test_window_stream_cg_split_hops_stay_identical():
    sr = TSEMI["sssp"]
    plain = tcore.run_window_stream_batched(_tstore(seed=31), sr, 0, 3,
                                            campaign_width=2)
    split = tcore.run_window_stream_batched(_tstore(seed=31), sr, 0, 3,
                                            campaign_width=2, cg_split=3)
    assert split.anchor_events == plain.anchor_events
    for wnd in plain.results:
        _same(split.results[wnd], _np(plain.results[wnd]), f"{wnd}")


def test_window_stream_back_to_back_hits_memory():
    sr = TSEMI["sssp"]
    ts = _tstore()
    first = tcore.run_window_stream_batched(ts, sr, 0, 3, campaign_width=2)
    again = tcore.run_window_stream_batched(ts, sr, 0, 3, campaign_width=2)
    assert again.anchor_events == ["hit"] * len(first.campaigns)
    for wnd in first.results:
        _same(again.results[wnd], _np(first.results[wnd]), f"{wnd}")


def test_window_stream_advancing_calls_rebuild_only_on_extension():
    """A later call whose stream extends past every cached anchor pays one
    rebuild, then hops again; events equal the reference's."""
    js, ts = _stores()
    events = []
    for module, store, sr in ((tcore, ts, TSEMI["sssp"]),
                              (jcore, js, JSEMI["sssp"])):
        ws = module.WindowStream(campaign_width=2)
        ws.extend(module.slide_windows(SNAPS, 3)[:4])
        first = module.run_window_stream_batched(store, sr, 0, stream=ws)
        ws.extend(module.slide_windows(SNAPS, 3)[4:])
        second = module.run_window_stream_batched(store, sr, 0, stream=ws)
        events.append((first.anchor_events, second.anchor_events))
        if module is tcore:
            runs = (first, second)
    assert events[0] == events[1]
    assert events[0][0] == ["rebuild", "hop"]
    assert events[0][1][0] == "rebuild"
    assert set(events[0][1][1:]) <= {"hop", "hit"}
    cold_store = _tstore()
    for run in runs:
        for campaign, anchor in zip(run.campaigns, run.anchors):
            cold = tcore.run_window_slide_batched(cold_store, TSEMI["sssp"],
                                                  0, windows=campaign,
                                                  anchor=anchor)
            for wnd in campaign:
                _same(run.results[wnd], _np(cold.results[wnd]), f"{wnd}")

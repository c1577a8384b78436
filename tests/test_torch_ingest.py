"""The port's live ingestion (``repro_torch.core.ingest``) and live store
(``SnapshotStore`` floors and compaction), held against the JAX package bit
for bit.

Counterparts of the 18 tests of tests/test_ingest.py, each also run on the
reference over the same event trace where it has a result to compare:
replayed snapshots, Δ pairs, window caches, ``IngestMetrics``, floors and
query values (all five semirings) equal the reference's and the
precomputed sequence's. Also the two compaction tests of
tests/test_window_stream.py, the store's LRU accounting across a
compaction, ``BENCH_ingest``'s smoke ``exact`` fields to the digit, and
``evolve --ingest`` on the CPU.
"""

import dataclasses
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.graph import make_evolving_sequence  # noqa: E402
from repro.graph.semiring import ALL_SEMIRINGS as JSEMI  # noqa: E402
from _torch_inputs import one_torch_thread  # noqa: E402,F401
from repro_torch import core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import window as twindow  # noqa: E402
from repro_torch.core.snapshots import anchor_tag  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SEMIRINGS = sorted(JSEMI)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _seqs(n=200, e=1400, snaps=5, changes=100, seed=11):
    """The same evolving sequence for the reference and for the port."""
    seq = make_evolving_sequence(n, e, snaps, changes, seed=seed)
    return seq, interop.sequence_from_arrays(
        seq.num_nodes, seq.snapshot_keys, seq.additions, seq.deletions,
        seq.weight_seed)


def _store(core, seq):
    if core is tcore:
        return tcore.SnapshotStore(seq, device="cpu")
    return jcore.SnapshotStore(seq)


def _live(core, num_nodes, weight_seed=0, **log_kw):
    """Fresh (store, log, watermark) over an empty live sequence."""
    store = _store(core, core.LiveSequence(num_nodes,
                                           weight_seed=weight_seed))
    log = core.EdgeLog(num_nodes, metrics=core.IngestMetrics(), **log_kw)
    return store, log, core.Watermark(log, store)


def _replayed(core, seq, **log_kw):
    store, log, wm = _live(core, seq.num_nodes, seq.weight_seed, **log_kw)
    cuts = core.replay_events(log, wm, core.events_from_sequence(seq))
    return store, wm, cuts


def _assert_live_store(t, j, msg=""):
    """Port live store == reference live store: sequence arrays (retired
    entries included), window cache, floors and ``first_live``."""
    tseq, jseq = t.seq, j.seq
    for field in ("snapshot_keys", "additions", "deletions"):
        ta, ja = getattr(tseq, field), getattr(jseq, field)
        assert len(ta) == len(ja), f"{msg} {field}"
        for a, b in zip(ta, ja):
            assert (a is None) == (b is None), f"{msg} {field}"
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"{msg} {field}")
                assert a.dtype == b.dtype
    assert sorted(t._t) == sorted(j._t), msg
    for w in j._t:
        np.testing.assert_array_equal(t._t[w], j._t[w], err_msg=f"{msg} {w}")
    assert t._floors == j._floors and t.first_live == j.first_live, msg
    assert t.stored_edges == j.stored_edges, msg


def _metrics(wm):
    return dataclasses.asdict(wm.metrics)


def _same(t, j, msg):
    np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=msg)


# -- replay bit-identity ------------------------------------------------------

def test_replay_bit_identical_structure():
    """Snapshots + canonical Δ pairs cut from the firehose equal the
    precomputed sequence and the reference's replay exactly, with zero
    redundancy or loss; the event traces are equal too."""
    jseq, tseq = _seqs()
    assert tcore.events_from_sequence(tseq) == \
        [tuple(ev) for ev in jcore.events_from_sequence(jseq)]
    store, wm, cuts = _replayed(tcore, tseq)
    jstore, jwm, jcuts = _replayed(jcore, jseq)
    assert cuts == jcuts == list(range(tseq.num_snapshots))
    _assert_live_store(store, jstore)
    assert _metrics(wm) == _metrics(jwm)
    for i in range(tseq.num_snapshots):
        np.testing.assert_array_equal(store.seq.snapshot_keys[i],
                                      tseq.snapshot_keys[i])
    for t in range(tseq.num_snapshots - 1):
        np.testing.assert_array_equal(store.seq.additions[t],
                                      tseq.additions[t])
        np.testing.assert_array_equal(store.seq.deletions[t],
                                      tseq.deletions[t])
    m = wm.metrics
    assert m.cuts == tseq.num_snapshots
    assert m.late_events == m.dropped == m.stalls == m.redundant_events == 0
    assert m.applied_additions == sum(len(a) for a in tseq.additions) \
        + len(tseq.snapshot_keys[0])
    assert m.applied_deletions == sum(len(d) for d in tseq.deletions)


@pytest.mark.parametrize("alg", SEMIRINGS)
def test_replay_values_bit_identical_all_semirings(alg):
    """Query values over the replayed store equal the precomputed store's
    and the reference's replayed store's, bit for bit."""
    jseq, tseq = _seqs(n=150, e=1000, snaps=4)
    live, _, _ = _replayed(tcore, tseq)
    jlive, _, _ = _replayed(jcore, jseq)
    ref = tcore.SnapshotStore(tseq, device="cpu")
    a = tcore.run_window_slide_batched(live, TSEMI[alg], 0, 2)
    b = tcore.run_window_slide_batched(ref, TSEMI[alg], 0, 2)
    c = jcore.run_window_slide_batched(jlive, JSEMI[alg], 0, 2)
    assert list(a.results) == list(b.results) == list(c.results)
    for wnd in b.results:
        _same(a.results[wnd], _np(b.results[wnd]), f"{alg} {wnd}")
        _same(a.results[wnd], c.results[wnd], f"{alg} {wnd} reference")


def test_online_common_graph_matches_batch_intersection():
    """The incrementally shrunk common graph equals the batch T(0, n-1),
    is installed in the window cache, and its shrinkage telescopes."""
    jseq, tseq = _seqs()
    live, wm, _ = _replayed(tcore, tseq)
    ref = tcore.SnapshotStore(tseq, device="cpu")
    last = tseq.num_snapshots - 1
    expected = ref.window_keys(0, last)
    np.testing.assert_array_equal(live._t[(0, last)], expected)
    np.testing.assert_array_equal(
        expected, jcore.SnapshotStore(jseq).window_keys(0, last))
    assert wm.metrics.common_shrinkage == \
        len(tseq.snapshot_keys[0]) - len(expected)


# -- EdgeLog: validation, ticks, lateness, backpressure -----------------------

def test_edge_log_validation():
    for core in (tcore, jcore):
        with pytest.raises(ValueError):
            core.EdgeLog(10, policy="shed")
        with pytest.raises(ValueError):
            core.EdgeLog(10, max_pending_events=0)
        log = core.EdgeLog(10)
        with pytest.raises(ValueError):
            log.append(0, 1, op="toggle")
        with pytest.raises(ValueError):
            log.append(0, 10)


def test_default_ts_follows_latest_stamp():
    """ts=None events belong to the current tick, the latest stamped ts."""
    for core in (tcore, jcore):
        log = core.EdgeLog(10)
        assert log.append(0, 1).ts == 0
        log.append(1, 2, ts=5)
        assert tuple(log.append(2, 3, w=0.5)) == (5, 2, 3, "add", 0.5)
        assert log.pending_events() == 3


def test_late_events_rejected_after_seal():
    for core in (tcore, jcore):
        store, log, wm = _live(core, 10)
        log.append(0, 1, ts=3)
        assert wm.advance(3).cut() == 0
        assert log.append(1, 2, ts=3) is None      # at the seal: late
        assert log.append(1, 2, ts=2) is None      # below it: late
        assert log.metrics.late_events == 2
        assert log.append(1, 2, ts=4) is not None  # above it: accepted
        assert log.extend([core.EdgeEvent(2, 3, 4),
                           core.EdgeEvent(4, 3, 4)]) == 1


def _policy_run(core, policy):
    store, log, wm = _live(core, 10, max_pending_events=2, policy=policy)
    log.append(0, 1)
    log.append(1, 2)
    if policy == "block":
        with pytest.raises(core.BackpressureStall):
            log.append(2, 3)
        wm.advance(0).cut()                        # cut empties the buffer
        assert log.append(2, 3, ts=1) is not None
    else:
        assert log.append(2, 3) is None
    return log


@pytest.mark.parametrize("policy", ["block", "drop"])
def test_bounded_policies_meter_like_reference(policy):
    """``block`` stalls until a cut (the stalled event is not counted);
    ``drop`` is lossy and metered; the port's metrics equal the
    reference's."""
    log = _policy_run(tcore, policy)
    jlog = _policy_run(jcore, policy)
    assert dataclasses.asdict(log.metrics) == dataclasses.asdict(jlog.metrics)
    m = log.metrics
    if policy == "block":
        assert m.stalls == 1 and m.events == 3
    else:
        assert m.dropped == 1 and m.events == 2
        assert log.pending_events() == 2


def test_spill_policy_is_lossless_and_deterministic():
    """A tiny spill buffer replays any trace to the same snapshots as an
    unbounded log; spilled events rejoin in (ts, arrival) order; metrics
    equal the reference's."""
    jseq, tseq = _seqs(n=80, e=300, snaps=4, changes=40)
    free, _, _ = _replayed(tcore, tseq)
    tight, wm, _ = _replayed(tcore, tseq, max_pending_events=16,
                             policy="spill")
    jtight, jwm, _ = _replayed(jcore, jseq, max_pending_events=16,
                               policy="spill")
    assert wm.metrics.spilled > 0
    assert _metrics(wm) == _metrics(jwm)
    _assert_live_store(tight, jtight)
    for i in range(tseq.num_snapshots):
        np.testing.assert_array_equal(tight.seq.snapshot_keys[i],
                                      free.seq.snapshot_keys[i])


# -- Watermark: guards, last-op-wins, sealing ---------------------------------

def test_watermark_guards():
    for core in (tcore, jcore):
        store, log, wm = _live(core, 10)
        with pytest.raises(ValueError):
            wm.cut()                               # advance first
        wm.advance(4)
        with pytest.raises(ValueError):
            wm.advance(3)                          # no regressions
        assert wm.ts == 4
        assert wm.advance(4).cut() == 0            # first cut may be empty
        assert store.seq.snapshot_keys[0].shape == (0,)
        assert wm.advance(9).cut() is None         # empty cut: no duplicate


def _last_op_wins(core):
    store, log, wm = _live(core, 10)
    log.append(0, 1, ts=0)
    log.append(0, 2, ts=0)
    assert wm.advance(0).cut() == 0
    log.append(0, 3, ts=1)                          # add then del: net del
    log.append(0, 3, op="del", ts=1)                # ... of an absent edge
    log.append(0, 1, op="del", ts=1)                # real deletion
    assert wm.advance(1).cut() == 1
    return store, wm


def test_cut_last_op_wins_and_meters_redundancy():
    store, wm = _last_op_wins(tcore)
    jstore, jwm = _last_op_wins(jcore)
    m = wm.metrics
    assert m.redundant_events == 2
    assert m.applied_deletions == 1
    assert store.seq.snapshot_keys[1].shape == (1,)  # only (0, 2) remains
    np.testing.assert_array_equal(store.seq.deletions[0],
                                  store.seq.snapshot_keys[0][:1])
    assert _metrics(wm) == _metrics(jwm)
    _assert_live_store(store, jstore)


def test_out_of_order_within_tick_is_timestamp_ordered():
    """Events may arrive out of ts order above the seal; the cut consumes
    them in (ts, arrival) order."""
    for core in (tcore, jcore):
        store, log, wm = _live(core, 10)
        log.append(0, 1, ts=2)
        log.append(0, 1, op="del", ts=5)           # later tick wins
        log.append(0, 2, ts=4)
        assert wm.advance(5).cut() == 0
        assert store.seq.snapshot_keys[0].shape == (1,)
        assert core.replay_events(core.EdgeLog(10),
                                  core.Watermark(core.EdgeLog(10), store),
                                  []) == []
        with pytest.raises(ValueError):             # replay needs sorted ts
            core.replay_events(*_live(core, 10)[1:],
                               [core.EdgeEvent(3, 0, 1),
                                core.EdgeEvent(1, 0, 2)])


# -- compaction + floors ------------------------------------------------------

def _floor_then_retire(core, seq):
    store, wm, _ = _replayed(core, seq)
    feed = core.LiveWindowFeed(store, width=2, name="lagging")
    assert feed.poll() == [(i, i + 1) for i in range(seq.num_snapshots - 1)]
    stats = wm.compact()                            # floor 0: nothing retires
    assert stats.retired == 0 and store.first_live == 0
    feed.advance_floor(3)                           # consumer is at (3, 4)
    before = store.stored_edges
    stats = wm.compact()
    assert stats.retired == 3 and store.first_live == 3
    assert store.stored_edges < before              # strictly fewer edges
    assert wm.metrics.freed_edges == stats.freed_edges > 0
    store.window_keys(3, 4)                         # live range still serves
    with pytest.raises(ValueError):
        store.window_keys(2, 4)                     # retired range does not
    feed.close()
    last = wm.compact()
    assert last.horizon == seq.num_snapshots - 1
    return store, wm, (stats.horizon, stats.retired, stats.freed_edges)


def test_compact_respects_feed_floor_then_retires():
    jseq, tseq = _seqs()
    store, wm, stats = _floor_then_retire(tcore, tseq)
    jstore, jwm, jstats = _floor_then_retire(jcore, jseq)
    assert stats == jstats
    assert _metrics(wm) == _metrics(jwm)
    _assert_live_store(store, jstore)


def _rebase(core, seq, events):
    split = next(i for i, ev in enumerate(events) if ev.ts == 4)
    store, log, wm = _live(core, seq.num_nodes, seq.weight_seed)
    core.replay_events(log, wm, events[:split])     # snapshots 0..3
    store.set_floor("consumer", 2)
    wm.compact()
    assert store.first_live == 2
    core.replay_events(log, wm, events[split:])     # snapshots 4, 5
    return store, wm


def test_cut_rebases_common_graph_after_compaction():
    """Compaction moves the live base; the next cut rebases its running
    intersection to T(first_live, ·) and stays bit-identical."""
    jseq, tseq = _seqs(snaps=6)
    store, wm = _rebase(tcore, tseq, tcore.events_from_sequence(tseq))
    jstore, jwm = _rebase(jcore, jseq, jcore.events_from_sequence(jseq))
    ref = tcore.SnapshotStore(tseq, device="cpu")
    for i in range(2, tseq.num_snapshots):
        np.testing.assert_array_equal(store.seq.snapshot_keys[i],
                                      tseq.snapshot_keys[i])
    np.testing.assert_array_equal(store._t[(2, 5)], ref.window_keys(2, 5))
    _assert_live_store(store, jstore)
    assert _metrics(wm) == _metrics(jwm)


def test_frozen_store_rejects_live_operations():
    _, tseq = _seqs(n=60, e=200, snaps=3, changes=30)
    store = tcore.SnapshotStore(tseq, device="cpu")
    empty = np.empty(0, np.int64)
    with pytest.raises(TypeError):
        store.ingest_cut(empty, empty, empty)
    with pytest.raises(TypeError):
        store.compact()


def test_compaction_drops_blocks_with_reference_accounting():
    """Across two compactions the port's device-block cache drops the same
    tags as the reference's (a pinned tag kept), with equal
    ``cached_nbytes``, ``evictions`` and LRU order, under a byte budget."""
    jseq, tseq = _seqs(snaps=6)
    stores = []
    for core, seq in ((tcore, tseq), (jcore, jseq)):
        store, log, wm = _live(core, seq.num_nodes, seq.weight_seed)
        store.cache_bytes = 40 * 1024
        core.replay_events(log, wm, core.events_from_sequence(seq))
        store.pin(("T", 1, 5))
        store.window_block(1, 5)
        semi = TSEMI if core is tcore else JSEMI
        core.run_window_slide_batched(store, semi["sssp"], 0, 2)
        core.run_window_stream_batched(store, semi["bfs"], 0, 3,
                                       campaign_width=2)
        stores.append((store, wm))
    (ts, twm), (js, jwm) = stores

    def same_cache():
        assert list(ts._blocks) == [_norm(tag) for tag in js._blocks]
        assert (ts.cached_nbytes, ts.evictions) == \
            (js.cached_nbytes, js.evictions)
        assert ts.cached_nbytes == sum(
            tcore.snapshots._block_nbytes(blk) for blk in ts._blocks.values())

    same_cache()
    assert ts.evictions > 0
    for before, floor in ((1, None), (None, 3)):
        if floor is not None:
            ts.set_floor("x", floor)
            js.set_floor("x", floor)
        tstats, jstats = twm.compact(before), jwm.compact(before)
        assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)
        assert tstats.retired > 0
        same_cache()
        _assert_live_store(ts, js)
        assert ("T", 1, 5) in ts._blocks            # pinned: kept
    assert ts.first_live == 3
    assert all(tcore.snapshots._tag_min_index(tag) >= 3
               for tag in ts._blocks if tag != ("T", 1, 5))


def _norm(tag):
    """A cache tag with the reference's ``gated`` dropped from its qkey."""
    if tag[0] == "AS" and len(tag[1]) == 6:
        return ("AS", tag[1][:3] + tag[1][4:], tag[2])
    return tag


# -- compaction vs pinned anchor states (tests/test_window_stream.py) --------

def _live_store(n=240, e=1800, snaps=8, changes=120, seed=11):
    """A port store whose snapshots were born from a replayed firehose."""
    _, tseq = _seqs(n, e, snaps, changes, seed)
    store, _, _ = _replayed(tcore, tseq)
    return store


def test_compact_never_retires_pinned_anchor_window():
    """Compaction clamps its horizon to every pinned "AS" link's window
    low: the pinned window still serves."""
    store = _live_store()
    qkey = twindow._stream_qkey(TSEMI["sssp"], 0, 10_000, 1, False)
    store.pin(anchor_tag(qkey, (2, 7)))
    stats = store.compact()              # wants 7; the pin clamps to 2
    assert stats.horizon == 2 and stats.retired == 2
    assert store.first_live == 2
    store.window_keys(2, 7)
    store.unpin(anchor_tag(qkey, (2, 7)))
    assert store.compact().retired == 5  # unpinned: the clamp lifts


def test_compact_clamps_to_anchor_chain_pins_of_lagging_stream():
    """An AnchorChain pins the links its registered streams are behind;
    compaction respects them until the laggard advances or unregisters,
    and the pinned anchor states survive the purge."""
    sr = TSEMI["sssp"]
    store = _live_store()
    chain = tcore.AnchorChain(store, name="shared")
    chain.register("laggard")            # behind everything: pins every link
    lead = tcore.WindowStream(campaign_width=2, name="lead",
                              windows=tcore.slide_windows(8, 3))
    tcore.run_window_stream_batched(store, sr, 0, stream=lead, chain=chain)
    lows = sorted(w[0] for w in chain.links)
    assert len(lows) > 1
    assert store.compact().horizon == lows[0]   # laggard keeps everything
    pinned_tags = store.pinned_tags()
    assert pinned_tags and all(tag in store._blocks for tag in pinned_tags)
    chain.advance("laggard", chain.links[-1])   # at the newest link now
    stats = store.compact()
    assert stats.horizon == lows[-1] > lows[0]  # only that link clamps
    store.window_keys(lows[-1], store.seq.num_snapshots - 1)
    chain.unregister("laggard")
    chain.unregister("lead")
    assert store.compact().horizon == store.seq.num_snapshots - 1


def test_slide_defaults_anchor_at_first_live():
    """After a compaction ``slide_block``/``slide_stack`` and
    ``common_graph_view`` default to the live range, as the reference's
    do, with the same blocks."""
    jseq, tseq = _seqs(snaps=6)
    ts, twm, _ = _replayed(tcore, tseq)
    js, jwm, _ = _replayed(jcore, jseq)
    for store, wm in ((ts, twm), (js, jwm)):
        store.set_floor("c", 2)
        wm.compact()
    for t, j in ((ts.slide_block((3, 4)), js.slide_block((3, 4))),
                 (ts.slide_stack([(2, 3), (3, 5)], num_lanes=4),
                  js.slide_stack([(2, 3), (3, 5)], num_lanes=4)),
                 (ts.common_graph_view().blocks[0],
                  js.common_graph_view().blocks[0])):
        for a, b in zip(t, j):
            _same(a, b, "block")
    assert ("D", (2, 5), (3, 4)) in ts._blocks
    assert ("T", 2, 5) in ts._blocks


# -- feed wiring: WindowStream + QueryService ---------------------------------

def test_live_window_feed_validation_and_cursor():
    for core in (tcore, jcore):
        store, _, _ = _live(core, 10)
        with pytest.raises(ValueError):
            core.LiveWindowFeed(store, width=0)
        with pytest.raises(ValueError):
            core.LiveWindowFeed(store, width=2, step=0)
        feed = core.LiveWindowFeed(store, width=2, name="f")
        assert feed.poll() == []                    # nothing born yet
        assert store._floors["f"] == 0
        feed.close()
        assert "f" not in store._floors


def _stream_live(core, seq, semi):
    store, log, wm = _live(core, seq.num_nodes, seq.weight_seed)
    stream = core.WindowStream(campaign_width=2, name="live",
                               feed=core.LiveWindowFeed(store, width=3,
                                                        name="live"))
    results = {}

    def on_cut(_idx):
        run = core.run_window_stream_batched(store, semi["sssp"], 0,
                                             stream=stream)
        results.update(run.results)

    core.replay_events(log, wm, core.events_from_sequence(seq),
                       on_cut=on_cut)
    return store, wm, results


def test_window_stream_feed_serves_windows_as_cut():
    """A feed-driven WindowStream serves windows as their last snapshot is
    cut, bit-identical to the precomputed slide and to the reference's
    live stream; draining advances the feed's floor."""
    jseq, tseq = _seqs()
    store, wm, results = _stream_live(tcore, tseq, TSEMI)
    jstore, jwm, jresults = _stream_live(jcore, jseq, JSEMI)
    ref = tcore.run_window_slide_batched(
        tcore.SnapshotStore(tseq, device="cpu"), TSEMI["sssp"], 0, 3)
    assert set(results) == set(ref.results) == set(jresults)
    for wnd, vals in ref.results.items():
        _same(results[wnd], _np(vals), f"{wnd}")
        _same(results[wnd], jresults[wnd], f"{wnd} reference")
    stats, jstats = wm.compact(), jwm.compact()
    assert stats.retired > 0
    assert (stats.horizon, stats.retired, stats.freed_edges) == \
        (jstats.horizon, jstats.retired, jstats.freed_edges)
    assert store.first_live == store._floors["live"]
    _assert_live_store(store, jstore)


def _service_live(core, seq, semi):
    store, log, wm = _live(core, seq.num_nodes, seq.weight_seed)
    service = core.QueryService(store)
    client = service.register(
        semi["sssp"], 0, campaign_width=2, name="live",
        feed=core.LiveWindowFeed(store, width=3, name="live"))
    core.replay_events(log, wm, core.events_from_sequence(seq),
                       on_cut=lambda _idx: service.turn())
    service.drain()
    return store, service, client


def test_query_service_feed_client_live():
    """register(feed=...) grows the client's horizon as snapshots are cut
    and serves born windows; results and launch records equal the
    reference's, and unregister closes the feed."""
    jseq, tseq = _seqs()
    store, service, client = _service_live(tcore, tseq, TSEMI)
    jstore, jservice, jclient = _service_live(jcore, jseq, JSEMI)
    assert client.horizon == tseq.num_snapshots - 1
    ref = tcore.run_window_slide_batched(
        tcore.SnapshotStore(tseq, device="cpu"), TSEMI["sssp"], 0, 3)
    assert set(client.results) == set(ref.results)
    assert list(client.results) == list(jclient.results)
    for wnd, vals in ref.results.items():
        _same(client.results[wnd], _np(vals), f"{wnd}")
        _same(client.results[wnd], jclient.results[wnd], f"{wnd} reference")
    assert [(r.anchor, r.windows, r.anchor_events, r.edge_work)
            for r in service.launch_log] == \
        [(r.anchor, r.windows, r.anchor_events, r.edge_work)
         for r in jservice.launch_log]
    assert store._floors == jstore._floors
    service.unregister(client)
    assert "live" not in store._floors


# -- the ingest bench and the CLI ---------------------------------------------

def _exact(bench):
    path = REPO / "benchmarks" / "baselines" / "smoke" / f"BENCH_{bench}.json"
    return {row["name"]: row["exact"]
            for row in json.loads(path.read_text())["rows"]}


def test_ingest_reproduces_smoke_baseline():
    """``BENCH_ingest``'s smoke row's exact fields to the digit, computed
    as ``benchmarks/ingest.py`` does (n 400, e 3,000, 6 snapshots, 200
    changes, width 3, campaign width 2, spill at 1,024 pending, seed 7):
    a live stream served after every cut, then a compaction; and the five
    semirings' slides over the ingested store equal the precomputed
    store's."""
    _, tseq = _seqs(400, 3_000, 6, 200, 7)
    sr = TSEMI["sssp"]
    live, log, wm = _live(tcore, tseq.num_nodes, tseq.weight_seed,
                          max_pending_events=1_024, policy="spill")
    stream = tcore.WindowStream(2, name="live-ingest",
                                feed=tcore.LiveWindowFeed(live, width=3))
    results = {}

    def on_cut(_idx):
        results.update(tcore.run_window_stream_batched(
            live, sr, 0, stream=stream).results)

    tcore.replay_events(log, wm, tcore.events_from_sequence(tseq),
                        on_cut=on_cut)
    bit_identical = all(
        np.array_equal(live.seq.snapshot_keys[i], tseq.snapshot_keys[i])
        for i in range(6)) and all(
        np.array_equal(live.seq.additions[t], tseq.additions[t])
        and np.array_equal(live.seq.deletions[t], tseq.deletions[t])
        for t in range(5))
    ref = tcore.SnapshotStore(tseq, device="cpu")
    ref_slide = tcore.run_window_slide_batched(ref, sr, 0, 3)
    assert set(results) == set(ref_slide.results)
    for wnd, vals in ref_slide.results.items():
        bit_identical &= torch.equal(results[wnd], vals)
    for name in SEMIRINGS:
        a = tcore.run_window_slide_batched(live, TSEMI[name], 0, 3)
        b = tcore.run_window_slide_batched(ref, TSEMI[name], 0, 3)
        for wnd, vals in b.results.items():
            bit_identical &= torch.equal(a.results[wnd], vals)
    before = live.stored_edges
    stats = wm.compact()
    after = live.stored_edges
    assert stats.retired > 0 and after < before
    live.window_keys(live.first_live, 5)
    got = {**dataclasses.asdict(wm.metrics), "stored_edges_before": before,
           "stored_edges_after": after, "windows_served": len(results),
           "bit_identical": bool(bit_identical)}
    assert got == _exact("ingest")["ingest/replay"]


def test_evolve_ingest_on_cpu(capsys):
    """``evolve --ingest --device cpu``: the cut-born store is asserted
    bit-identical and every mode and window verifies over it."""
    from repro_torch.launch import evolve
    summary = evolve.main(["--nodes", "300", "--edges", "2000",
                           "--snapshots", "5", "--changes", "120",
                           "--alg", "bfs", "--verify", "--device", "cpu",
                           "--ingest", "--window", "3", "--window-batch",
                           "--stream"])
    out = capsys.readouterr().out
    assert summary["verified"]
    assert "[evolve] ingest: replayed 2480 events -> 5 cuts" in out
    assert "(+2240/-240 applied" in out
    assert "snapshots bit-identical to the precomputed sequence" in out
    assert "verify: window slide exact on every window" in out

"""The port's anchor-state cache, campaign planner and anchor chains
(``repro_torch.core.window``), held against the JAX package bit for bit.

Counterparts of the anchor-state cache tests of tests/test_window_stream.py
and of the planner and chain tests of tests/test_campaigns.py: cache
bytes, evictions and rebuild events equal the reference store's;
plans equal the reference's (campaigns, anchors, ``slide_edges``,
``anchor_edges``, ``padding_edges``, ``total_edges``) for fixed widths,
the DP, a stable-fraction discount and a duck-typed cost model; auto runs
and shared chains equal the reference's runs (values, campaigns, anchors,
rebuild/hop/hit events, edge work, links); pins and evictions equal the
reference store's. Also: the committed ``BENCH_window_stream`` (both
widths, ``edge_work_delta_seed`` included) and ``BENCH_window_overlap``
smoke baselines reproduced to the digit.
"""

import json
import pathlib

import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as jcore  # noqa: E402
from repro.graph import make_evolving_sequence  # noqa: E402
from repro.graph.semiring import ALL_SEMIRINGS as JSEMI  # noqa: E402
from _torch_inputs import one_torch_thread  # noqa: E402,F401
from repro_torch import core as tcore  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import window as twindow  # noqa: E402
from repro_torch.core.snapshots import _block_nbytes as t_nbytes  # noqa: E402
from repro_torch.graph.engine import QueryState  # noqa: E402
from repro_torch.graph.semiring import ALL_SEMIRINGS as TSEMI  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
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


# -- anchor-state cache: LRU interplay ----------------------------------------

def test_anchor_state_cache_roundtrip_and_cover():
    ts = _tstore()
    run = tcore.run_window_stream_batched(ts, TSEMI["sssp"], 0, 3,
                                          campaign_width=2)
    qkey = _tqkey("sssp")
    for anchor in run.anchors:
        assert isinstance(ts.anchor_state_get(qkey, anchor), QueryState)
    lo = max(a for a, _ in run.anchors)
    hi = run.anchors[0][1]
    cover_window, state = ts.anchor_state_cover(qkey, (lo + 1, hi))
    assert cover_window == (lo, hi)
    assert isinstance(state, QueryState)
    assert ts.anchor_state_cover(qkey, (0, hi)) is None
    assert ts.anchor_state_get(_tqkey("sswp"), run.anchors[0]) is None


def test_anchor_state_eviction_mid_stream_forces_identical_rebuild():
    """A memory-tight store evicts anchor states between campaigns: more
    rebuilds, the same values, and the reference's events and evictions."""
    _, free = _stores(seed=13)
    jtight, tight = _stores(seed=13, cache_bytes=8 * 1024)
    sr = TSEMI["sssp"]
    a = tcore.run_window_stream_batched(free, sr, 0, 3, campaign_width=1)
    b = tcore.run_window_stream_batched(tight, sr, 0, 3, campaign_width=1)
    ref = jcore.run_window_stream_batched(jtight, JSEMI["sssp"], 0, 3,
                                          campaign_width=1)
    assert tight.evictions == jtight.evictions > 0
    assert a.anchor_rebuilds == 1 < b.anchor_rebuilds
    assert b.anchor_events == ref.anchor_events
    assert tight.cached_nbytes == jtight.cached_nbytes
    for wnd in a.results:
        _same(b.results[wnd], _np(a.results[wnd]), f"{wnd}")


def test_anchor_state_lru_accounting_across_overwrites():
    js, ts = _stores(seed=7)
    qkey = _tqkey("sssp")

    def actual():
        return sum(t_nbytes(b) for b in ts._blocks.values())

    jcore.run_window_stream_batched(js, JSEMI["sssp"], 0, 3, campaign_width=2)
    for _ in range(3):
        run = tcore.run_window_stream_batched(ts, TSEMI["sssp"], 0, 3,
                                              campaign_width=2)
        assert ts.cached_nbytes == actual() == js.cached_nbytes
        state = ts.anchor_state_get(qkey, run.anchors[0])
        before = ts.cached_nbytes
        ts.anchor_state_put(qkey, run.anchors[0], state)
        assert ts.cached_nbytes == before == actual()
        assert ts.release(("AS",)) > 0
        assert ts.cached_nbytes == actual()
        assert all(t[0] != "AS" for t in ts._blocks)
    ts.release()
    assert ts.cached_nbytes == 0


def test_release_AS_leaves_blocks_warm():
    ts = _tstore(seed=7)
    tcore.run_window_stream_batched(ts, TSEMI["sssp"], 0, 2,
                                    campaign_width=2)
    assert {"AS", "DS"} <= {t[0] for t in ts._blocks}
    ts.release(("AS",))
    families = {t[0] for t in ts._blocks}
    assert "AS" not in families and "DS" in families


# -- campaign planner ----------------------------------------------------------

@pytest.fixture(scope="module")
def planner_stores():
    """One store pair for the host-side planner tests (no relax runs)."""
    return _stores()


def test_optimal_campaigns_is_a_partition(planner_stores):
    js, ts = planner_stores
    windows = tcore.slide_windows(SNAPS, 3)
    plan = tcore.optimal_campaigns(ts, windows, lane_budget=4)
    assert [w for c in plan.campaigns for w in c] == windows
    assert all(1 <= len(c) <= 4 for c in plan.campaigns)
    assert plan.widths == [len(c) for c in plan.campaigns]
    assert plan.anchors == [(c[0][0], windows[-1][1]) for c in plan.campaigns]
    assert plan.total_edges == (plan.slide_edges + plan.anchor_edges
                                + plan.padding_edges)
    _assert_plan(plan, jcore.optimal_campaigns(js, windows, lane_budget=4))


def test_optimal_campaigns_validation(planner_stores):
    _, ts = planner_stores
    with pytest.raises(ValueError):
        tcore.optimal_campaigns(ts, [])
    with pytest.raises(ValueError):
        tcore.optimal_campaigns(ts, [(2, 4), (0, 3)])
    with pytest.raises(ValueError):
        tcore.optimal_campaigns(ts, [(0, 2)], lane_budget=0)
    with pytest.raises(ValueError):
        tcore.campaign_volume(ts, [])
    with pytest.raises(ValueError):
        tcore.campaign_volume(ts, [[]])
    with pytest.raises(ValueError):
        tcore.optimal_campaigns(ts, [(0, 2)], stable_milli=1001)


def test_campaign_volume_anchor_edges_telescope(planner_stores):
    js, ts = planner_stores
    windows = tcore.slide_windows(SNAPS, 2)
    for width in (1, 3):
        campaigns = tcore.stream_campaigns(windows, width)
        plan = tcore.campaign_volume(ts, campaigns)
        assert plan.anchor_edges == ts.window_size(*plan.anchors[-1])
        _assert_plan(plan, jcore.campaign_volume(js, campaigns), f"{width}")


def test_padding_volume_counts_masked_lanes(planner_stores):
    js, ts = planner_stores
    windows = tcore.slide_windows(SNAPS, 3)[:3]
    plan = tcore.campaign_volume(ts, [windows])
    deltas = [ts.window_size(*w) - ts.window_size(*plan.anchors[0])
              for w in windows]
    assert plan.padding_edges == (4 - 3) * max(deltas)
    meshed = tcore.campaign_volume(ts, [windows], data_extent=8)
    assert meshed.padding_edges == (8 - 3) * max(deltas)
    _assert_plan(meshed, jcore.campaign_volume(js, [windows], data_extent=8))


@st.composite
def advancing_windows(draw, snaps=SNAPS, max_windows=10):
    n = draw(st.integers(1, max_windows))
    lo = draw(st.integers(0, snaps - 1))
    hi = draw(st.integers(lo, snaps - 1))
    out = [(lo, hi)]
    for _ in range(n - 1):
        lo = draw(st.integers(lo, snaps - 1))
        hi = draw(st.integers(max(lo, hi), snaps - 1))
        out.append((lo, hi))
    return out


@settings(max_examples=60, deadline=None)
@given(windows=advancing_windows(), data_extent=st.sampled_from([1, 2, 4]),
       stable_milli=st.sampled_from([0, 500, 952]))
def test_optimal_campaigns_equals_reference_and_beats_fixed_widths(
        planner_stores, windows, data_extent, stable_milli):
    """The DP's plan equals the reference's, and its modeled volume is ≤
    every fixed campaign width's on the same windows."""
    js, ts = planner_stores
    kw = dict(data_extent=data_extent, stable_milli=stable_milli)
    plan = tcore.optimal_campaigns(ts, windows, lane_budget=8, **kw)
    _assert_plan(plan, jcore.optimal_campaigns(js, windows, lane_budget=8,
                                               **kw), f"{windows}")
    for width in (1, 2, 4, 8):
        fixed = tcore.campaign_volume(
            ts, tcore.stream_campaigns(windows, width), **kw)
        assert plan.total_edges <= fixed.total_edges


class _CostModel:
    """A duck-typed cost model: integer prices per hop and anchor."""

    def hop_cost(self, edges):
        return 100 + 3 * edges

    def anchor_cost(self, edges):
        return 50 + 2 * edges


def test_cost_model_is_duck_typed_as_in_reference(planner_stores):
    js, ts = planner_stores
    windows = tcore.slide_windows(SNAPS, 2)
    plan = tcore.optimal_campaigns(ts, windows, cost_model=_CostModel())
    _assert_plan(plan, jcore.optimal_campaigns(js, windows,
                                               cost_model=_CostModel()))
    assert isinstance(plan.cost_model, _CostModel)


def test_auto_run_realizes_planned_volumes():
    """campaign_width="auto" streams what its plan predicted, equals a
    fixed-width run's values and the reference's auto run."""
    js, ts = _stores()
    sr = TSEMI["sssp"]
    auto = tcore.run_window_stream_batched(ts, sr, 0, 3,
                                           campaign_width="auto",
                                           stable_milli=900)
    assert auto.plan is not None and auto.plan.stable_milli == 900
    assert [w for c in auto.campaigns for w in c] == \
        tcore.slide_windows(SNAPS, 3)
    _assert_stream(auto, jcore.run_window_stream_batched(
        js, JSEMI["sssp"], 0, 3, campaign_width="auto", stable_milli=900),
        "auto")
    raw = tcore.run_window_stream_batched(_tstore(), sr, 0, 3,
                                          campaign_width="auto")
    assert raw.added_edges == raw.plan.slide_edges
    assert raw.anchor_delta_edges == \
        raw.plan.anchor_edges - ts.window_size(*raw.plan.anchors[0])
    fixed = tcore.run_window_stream_batched(_tstore(), sr, 0, 3,
                                            campaign_width=2)
    assert set(auto.results) == set(fixed.results)
    for wnd in fixed.results:
        _same(auto.results[wnd], _np(fixed.results[wnd]), f"{wnd}")


def test_auto_respects_lane_budget():
    sr = TSEMI["sssp"]
    run = tcore.run_window_stream_batched(_tstore(), sr, 0, 3,
                                          campaign_width="auto",
                                          lane_budget=2)
    assert run.plan.lane_budget == 2
    assert all(w <= 2 for w in run.plan.widths)
    with pytest.raises(ValueError):
        tcore.run_window_stream_batched(_tstore(), sr, 0, 3,
                                        campaign_width="auto", lane_budget=0)


def test_auto_stream_object_round_trip():
    sr = TSEMI["sssp"]
    ws = tcore.WindowStream(campaign_width="auto",
                            windows=tcore.slide_windows(SNAPS, 3))
    run = tcore.run_window_stream_batched(_tstore(), sr, 0, stream=ws)
    assert run.plan is not None and run.results
    fixed = tcore.run_window_stream_batched(_tstore(), sr, 0, 3,
                                            campaign_width=2)
    for wnd in fixed.results:
        _same(run.results[wnd], _np(fixed.results[wnd]), f"{wnd}")


def test_campaign_width_sentinel_plumbing():
    windows = tcore.slide_windows(SNAPS, 3)
    with pytest.raises(ValueError, match="optimal_campaigns"):
        tcore.stream_campaigns(windows, "auto")
    for junk in (0, "wide"):
        with pytest.raises(ValueError, match='"auto"'):
            tcore.stream_campaigns(windows, junk)
        with pytest.raises(ValueError, match='"auto"'):
            tcore.WindowStream(campaign_width=junk)
    assert tcore.WindowStream(campaign_width="auto").campaign_width == "auto"


def test_window_stream_names_are_unique_by_default():
    a, b = tcore.WindowStream(campaign_width=1), \
        tcore.WindowStream(campaign_width=1)
    assert a.name != b.name and a.name.startswith("stream-")
    assert tcore.WindowStream(campaign_width=1, name="fixed").name == "fixed"


# -- anchor chains: overlapping streams ---------------------------------------

def _overlapping_sets():
    """Two window sets over the same tail: B starts later, same stream_hi."""
    return (tcore.slide_windows(SNAPS, 3), tcore.slide_windows(SNAPS, 2)[3:])


def _shared_chain_runs(module, store, sr):
    wa, wb = _overlapping_sets()
    chain = module.AnchorChain(store, name="shared")
    a = module.WindowStream(campaign_width=2, windows=wa, name="A")
    b = module.WindowStream(campaign_width=2, windows=wb, name="B")
    chain.register(b)   # B not yet running: A's links must stay pinned
    ra = module.run_window_stream_batched(store, sr, 0, stream=a, chain=chain)
    rb = module.run_window_stream_batched(store, sr, 0, stream=b, chain=chain)
    return chain, ra, rb


def test_overlapping_streams_share_chain_fewer_rebuilds():
    """Two streams sharing a chain rebuild strictly fewer anchors than
    solo runs, with the same values, and equal the reference's runs and
    links."""
    js, ts = _stores()
    sr = TSEMI["sssp"]
    chain, ra, rb = _shared_chain_runs(tcore, ts, sr)
    jchain, jra, jrb = _shared_chain_runs(jcore, js, JSEMI["sssp"])
    _assert_stream(ra, jra, "A")
    _assert_stream(rb, jrb, "B")
    assert chain.links == jchain.links
    assert chain.registered() == jchain.registered() == ["A", "B"]
    wa, wb = _overlapping_sets()
    solo_a = tcore.run_window_stream_batched(_tstore(), sr, 0, windows=wa,
                                             campaign_width=2)
    solo_b = tcore.run_window_stream_batched(_tstore(), sr, 0, windows=wb,
                                             campaign_width=2)
    assert (ra.anchor_rebuilds + rb.anchor_rebuilds
            < solo_a.anchor_rebuilds + solo_b.anchor_rebuilds)
    assert rb.anchor_rebuilds == 0
    for run, solo in ((ra, solo_a), (rb, solo_b)):
        for wnd in solo.results:
            _same(run.results[wnd], _np(solo.results[wnd]), f"{wnd}")


def test_chain_pins_follow_registration_lifecycle():
    ts = _tstore()
    sr = TSEMI["sssp"]
    wa, wb = _overlapping_sets()
    chain = tcore.AnchorChain(ts)
    a = tcore.WindowStream(campaign_width=2, windows=wa, name="A")
    b = tcore.WindowStream(campaign_width=2, windows=wb, name="B")
    chain.register(b)
    tcore.run_window_stream_batched(ts, sr, 0, stream=a, chain=chain)
    qkey = _tqkey("sssp")
    assert set(chain._pinned) == set(chain.links)
    assert {("AS", qkey, link) for link in chain.links} <= ts.pinned_tags()
    all_links = list(chain.links)
    tcore.run_window_stream_batched(ts, sr, 0, stream=b, chain=chain)
    pruned = set(all_links) - set(chain.links)
    assert pruned
    assert set(chain._pinned) == set(chain.links)
    assert {("AS", qkey, link) for link in pruned}.isdisjoint(
        ts.pinned_tags())
    chain.unregister(a)
    chain.unregister(b)
    assert chain.links and chain._pinned == set()
    assert ts.pinned_tags() == set()
    with pytest.raises(ValueError, match="not registered"):
        chain.unregister(b)
    with pytest.raises(ValueError):
        chain.advance("B", chain.links[0])


def test_pinned_links_survive_release_and_eviction():
    ts = _tstore()
    sr = TSEMI["sssp"]
    wa, wb = _overlapping_sets()
    chain = tcore.AnchorChain(ts)
    a = tcore.WindowStream(campaign_width=2, windows=wa, name="A")
    b = tcore.WindowStream(campaign_width=2, windows=wb, name="B")
    chain.register(b)
    tcore.run_window_stream_batched(ts, sr, 0, stream=a, chain=chain)
    qkey = _tqkey("sssp")
    assert ts.release() > 0
    assert set(ts._blocks) == {("AS", qkey, link) for link in chain.links}
    rb = tcore.run_window_stream_batched(ts, sr, 0, stream=b, chain=chain)
    assert rb.anchor_rebuilds == 0
    bare = _tstore()
    tcore.run_window_stream_batched(bare, sr, 0, windows=wa,
                                    campaign_width=2)
    bare.release()
    cold = tcore.run_window_stream_batched(bare, sr, 0, windows=wb,
                                           campaign_width=2)
    assert cold.anchor_rebuilds > 0
    for wnd in cold.results:
        _same(rb.results[wnd], _np(cold.results[wnd]), f"{wnd}")
    chain.unregister(a)
    chain.unregister(b)


def test_release_AS_skips_pinned_anchor_states_with_refcounts():
    ts = _tstore()
    tcore.run_window_stream_batched(ts, TSEMI["sssp"], 0,
                                    windows=tcore.slide_windows(SNAPS, 3),
                                    campaign_width=2)
    as_tags = sorted(t for t in ts._blocks if t[0] == "AS")
    assert len(as_tags) >= 2
    keep, dropped = as_tags[0], as_tags[1:]
    ts.pin(keep)
    ts.pin(keep)
    assert ts.pin_count(keep) == 2
    assert ts.release(("AS",)) > 0
    assert {t for t in ts._blocks if t[0] == "AS"} == {keep}
    assert ts.pin_count(keep) == 2
    assert all(ts.pin_count(t) == 0 for t in dropped)
    assert any(t[0] != "AS" for t in ts._blocks)
    ts.unpin(keep)
    ts.release(("AS",))
    assert keep in ts._blocks
    ts.unpin(keep)
    assert keep not in ts.pinned_tags()
    ts.release(("AS",))
    assert keep not in ts._blocks


def test_lru_eviction_skips_pinned_tags_with_exact_accounting():
    """Byte-budget eviction walks past pinned tags; evictions, order and
    bytes equal the reference store's."""
    js, ts = _stores(cache_bytes=256 * 1024)
    for store in (js, ts):
        store.window_block(0, 0)
        store.pin(("T", 0, 0))
        for i in range(SNAPS):
            for j in range(i, SNAPS):
                store.window_block(i, j)
    assert ts.evictions == js.evictions > 0
    assert list(ts._blocks) == list(js._blocks)
    assert ("T", 0, 0) in ts._blocks
    assert ts.cached_nbytes == js.cached_nbytes == \
        sum(t_nbytes(b) for b in ts._blocks.values())
    ts.unpin(("T", 0, 0))
    with pytest.raises(ValueError):
        ts.unpin(("T", 0, 0))


def test_chain_cover_and_select_tightest():
    ts = _tstore()
    chain = tcore.AnchorChain(ts, name="one")
    tcore.run_window_stream_batched(
        ts, TSEMI["sssp"], 0, chain=chain,
        stream=tcore.WindowStream(campaign_width=2, name="A",
                                  windows=tcore.slide_windows(SNAPS, 3)))
    hi = SNAPS - 1
    lo = max(link[0] for link in chain.links)
    assert chain.cover((lo + 1, hi)) == (lo, hi)
    assert chain.cover((lo, hi + 1)) is None
    empty = tcore.AnchorChain(ts, name="empty")
    assert tcore.select_chain([empty, chain], (lo + 1, hi)) is chain
    assert tcore.select_chain([empty], (lo + 1, hi)) is None
    assert tcore.select_chain([chain], (lo + 1, hi),
                              qkey=_tqkey("sswp")) is None


def test_chain_misuse_raises():
    ts = _tstore()
    sr = TSEMI["sssp"]
    chain = tcore.AnchorChain(ts)
    with pytest.raises(ValueError, match="requires stream="):
        tcore.run_window_stream_batched(ts, sr, 0, 3, chain=chain)
    with pytest.raises(ValueError, match="SnapshotStore"):
        tcore.run_window_stream_batched(
            _tstore(), sr, 0, chain=chain,
            stream=tcore.WindowStream(campaign_width=2,
                                      windows=tcore.slide_windows(SNAPS, 3)))
    ws = tcore.WindowStream(campaign_width=2,
                            windows=tcore.slide_windows(SNAPS, 3))
    tcore.run_window_stream_batched(ts, sr, 0, stream=ws, chain=chain)
    with pytest.raises(ValueError, match="bound to query key"):
        chain.bind(_tqkey("sswp"))
    chain.unregister(ws)


# -- the committed smoke baselines ---------------------------------------------

def _exact(bench):
    path = REPO / "benchmarks" / "baselines" / "smoke" / f"BENCH_{bench}.json"
    return {row["name"]: row["exact"]
            for row in json.loads(path.read_text())["rows"]}


def _total_work(run):
    return (sum(s.edge_work for s in run.anchor_stats)
            + sum(s.edge_work for s in run.hop_stats))


@pytest.fixture(scope="module")
def smoke_stream_store():
    """``benchmarks.run``'s window_stream smoke data (``SCALES``: 6
    snapshots and the bench's defaults n 10,000, e 100,000, 4,000
    changes, seed 0)."""
    _, tseq = _seq_pair(10_000, 100_000, 6, 4_000, 0)
    return tcore.SnapshotStore(tseq, device="cpu")


@pytest.mark.parametrize("width", [2, 3])
def test_window_stream_reproduces_smoke_baseline(smoke_stream_store, width):
    """The window_stream smoke rows' exact fields to the digit, computed as
    ``benchmarks/window_stream.py`` does (campaign width 2, sssp from 0):
    warm-up, cold anchors, then the full-Δ-seeded rerun and the cold
    per-campaign baseline."""
    store, sr = smoke_stream_store, TSEMI["sssp"]
    windows = tcore.slide_windows(6, width)
    tcore.run_window_stream_batched(store, sr, 0, windows=windows,
                                    campaign_width=2)
    store.release(("AS",))
    stream = tcore.run_window_stream_batched(store, sr, 0, windows=windows,
                                             campaign_width=2)
    store.release(("AS",))
    delta = tcore.run_window_stream_batched(store, sr, 0, windows=windows,
                                            campaign_width=2, seed="delta")
    cold = [tcore.run_window_slide_batched(store, sr, 0, windows=c, anchor=a)
            for c, a in zip(stream.campaigns, stream.anchors)]
    for cold_run, campaign in zip(cold, stream.campaigns):
        for wnd in campaign:
            _same(stream.results[wnd], _np(cold_run.results[wnd]), f"{wnd}")
    got = {"campaigns": len(stream.campaigns),
           "rebuilds_stream": stream.anchor_rebuilds,
           "anchor_hops": stream.anchor_hops,
           "rebuilds_cold": len(cold),
           "added_edges": stream.added_edges,
           "anchor_delta_edges": stream.anchor_delta_edges,
           "edge_work": int(round(_total_work(stream))),
           "edge_work_delta_seed": int(round(_total_work(delta))),
           "stable_fraction_milli": stream.stable_milli}
    assert got == _exact("window_stream")[f"window_stream/width{width}"]


def test_window_overlap_reproduces_smoke_baseline():
    """The window_overlap smoke row's exact fields to the digit, computed
    as ``benchmarks/window_stream.py``'s ``run_window_overlap_bench`` does
    (n 400, e 3,000, 6 snapshots, 200 changes, 2 streams, width 3,
    campaign width 2, seed 0, sssp from 0)."""
    _, tseq = _seq_pair(400, 3_000, 6, 200, 0)
    sr = TSEMI["sssp"]
    all_windows = tcore.slide_windows(6, 3)
    stagger = max(1, len(all_windows) // 2)
    window_sets = [all_windows[s * stagger:] for s in range(2)]
    store = tcore.SnapshotStore(tseq, device="cpu")
    chain = tcore.AnchorChain(store, name="overlap")
    streams = [tcore.WindowStream(campaign_width=2, windows=ws,
                                  name=f"overlap-{i}")
               for i, ws in enumerate(window_sets)]
    for s in streams:
        chain.register(s)
    shared = [tcore.run_window_stream_batched(store, sr, 0, stream=s,
                                              chain=chain) for s in streams]
    for s in streams:
        chain.unregister(s)
    solo = [tcore.run_window_stream_batched(
        tcore.SnapshotStore(tseq, device="cpu"), sr, 0, windows=ws,
        campaign_width=2) for ws in window_sets]
    for sh, so in zip(shared, solo):
        for wnd in so.results:
            _same(sh.results[wnd], _np(so.results[wnd]), f"{wnd}")
    got = {"streams": 2, "chain_links": len(chain.links),
           "rebuilds_shared": sum(r.anchor_rebuilds for r in shared),
           "hops_shared": sum(r.anchor_hops for r in shared),
           "hits_shared": sum(r.anchor_hits for r in shared),
           "rebuilds_solo": sum(r.anchor_rebuilds for r in solo),
           "hops_solo": sum(r.anchor_hops for r in solo),
           "added_edges": sum(r.added_edges for r in shared),
           "anchor_delta_edges": sum(r.anchor_delta_edges for r in shared),
           "shared_work": int(round(sum(map(_total_work, shared)))),
           "solo_work": int(round(sum(map(_total_work, solo)))),
           "auto_widths": tcore.optimal_campaigns(store, window_sets[0],
                                                  lane_budget=8).widths}
    assert got == _exact("window_overlap")["window_overlap/streams2"]

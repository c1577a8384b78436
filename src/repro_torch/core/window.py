"""Sliding-window executors and streaming campaigns (PyTorch port of
``repro.core.window``; the window plans, the campaign DP and the anchor
chain's bookkeeping are host code copied from the reference).

A *window* ``[i..j]`` is answered on its common graph T(i, j). Sliding is
not deletion-free between consecutive windows (``T(i,j) ⊄ T(i+1,j+1)`` in
general), so every window is reached from a common SUPER-window's apex:
for windows spanning ``[lo..hi]`` the tightest is ``T(lo, hi)``
(``window_anchor``). From one anchor fixpoint each window apex is one
addition-only hop (``SnapshotStore.slide_block``); the hops are
independent, so the batched executor stacks them as lanes of ONE
``incremental_additions_batched`` launch (``SnapshotStore.slide_stack``,
lane axis padded to ``lane_bucket(num_windows)`` with masked inert lanes).

Executor contract (held by tests/test_torch_window.py against the JAX
package):

* **Bit-identical results.** ``run_window_slide_batched`` returns values
  (and parents, when tracked) bit-identical to the sequential
  ``run_window_slide``, and both equal the reference's.
* **Work accounting.** Padding lanes never count toward ``edge_work``;
  batched and sequential slides report equal totals.
* **Results are views.** A batched run's per-window values are rows of
  the launch's fresh ``[L, N]`` output; nothing writes into them later.

Streaming campaigns (``WindowStream`` / ``run_window_stream_batched``) cut
an advancing window sequence into campaigns; campaign k anchors at
``(lo_k, stream_hi)``, so campaign k+1's anchor is nested in k's and its
state comes from one incremental hop off k's cached state (the store's
"AS" family) instead of a from-scratch rebuild. Values are bit-identical
to running ``run_window_slide_batched`` cold per campaign. The campaign
partition can be chosen by Δ volume (``optimal_campaigns``), and
overlapping streams can share one chain of pinned anchor states
(``AnchorChain``). The reference's ``mesh=`` and ``gated=`` options have
no counterpart here (one card; the port's kernel masks edge by edge).
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.core.kickstarter import StreamStats
from repro_torch.core.snapshots import SnapshotStore, anchor_tag, tightest_cover
from repro_torch.core.trigrid import _anchor_base, _anchor_view, hop_added_edges
from repro_torch.graph.edgeset import lane_bucket
from repro_torch.graph.engine import (
    QueryState,
    extract_state,
    gather_lane_states,
    host_sync,
    incremental_additions,
    incremental_additions_batched,
)
from repro_torch.graph.semiring import Semiring
from repro_torch.graph.stability import stable_fraction_milli

Window = tuple[int, int]


def slide_windows(num_snapshots: int, width: int, step: int = 1,
                  start: int = 0) -> list[Window]:
    """All width-``width`` windows sliding by ``step``: inclusive pairs
    ``(i, i + width - 1)``, the last ending at the final snapshot. A width
    covering the whole (remaining) sequence yields exactly one window."""
    if not 1 <= width <= num_snapshots - start:
        raise ValueError(
            f"window width {width} not in [1, {num_snapshots - start}] "
            f"(num_snapshots={num_snapshots}, start={start})")
    if step < 1:
        raise ValueError(f"step must be >= 1, got {step}")
    return [(i, i + width - 1)
            for i in range(start, num_snapshots - width + 1, step)]


def window_anchor(windows: list[Window]) -> Window:
    """Tightest common super-window: the span of all windows (every
    window's common graph contains the span's)."""
    if not windows:
        raise ValueError("need at least one window")
    return min(i for i, _ in windows), max(j for _, j in windows)


@dataclasses.dataclass
class WindowSlideRun:
    """Result record of one window slide: per-window values plus the
    shared-anchor fixpoint stats, per-hop stats and Δ-volume/lane
    accounting."""

    results: dict[Window, torch.Tensor]  # window -> values
    anchor: Window
    base_stats: StreamStats              # the shared anchor fixpoint
    hop_stats: list[StreamStats]         # per-window (seq) or 1 launch (batched)
    wall_s: float
    added_edges: int                     # total slide-Δ volume streamed
    # (valid lanes, lane_bucket) of the batched launch; empty when sequential
    lane_layout: "list[tuple[int, int]]" = dataclasses.field(
        default_factory=list)
    # measured stable fraction (‰) over all window hops (padding excluded)
    stable_milli: int = 0


def _slide_added_edges(store: SnapshotStore, windows: list[Window],
                       anchor: Window) -> int:
    """Total slide-Δ volume of hopping every window off ``anchor``: a sum
    of ``hop_added_edges`` atoms, the cost atom the campaign planner
    optimizes over."""
    return sum(hop_added_edges(store, anchor, w) for w in windows)


def _resolve(store: SnapshotStore, width: int | None, windows, step, start,
             anchor):
    if windows is None:
        if width is None:
            raise ValueError("pass either width= or windows=")
        windows = slide_windows(store.seq.num_snapshots, width, step=step,
                                start=start)
    windows = [tuple(w) for w in windows]
    if anchor is None:
        anchor = window_anchor(windows)
    return windows, tuple(anchor)


def run_window_slide(
    store: SnapshotStore,
    semiring: Semiring,
    source: int,
    width: int | None = None,
    *,
    windows: "list[Window] | None" = None,
    step: int = 1,
    start: int = 0,
    anchor: Window | None = None,
    max_iters: int = 10_000,
    cg_split: int = 1,
    track_parents: bool = False,
    seed: str = "instability",
    fused_k: int = 1,
) -> WindowSlideRun:
    """Sequential window slide: one anchor fixpoint, then one
    ``incremental_additions`` hop per window, seeded per the stable-vertex
    analysis (``seed="delta"``: full-Δ seeding, same values). ``fused_k``
    is the engine's fused-chunk launch option (same results at any value).
    """
    t_all = time.perf_counter()
    windows, anchor = _resolve(store, width, windows, step, start, anchor)
    anchor_view, base, base_stats = _anchor_base(
        store, anchor, semiring, source, max_iters, cg_split, track_parents,
        fused_k)

    results: dict[Window, torch.Tensor] = {}
    hop_stats: list[StreamStats] = []
    unstable_counts: list[int] = []
    for wnd in windows:
        t0 = time.perf_counter()
        delta = store.slide_block(wnd, anchor)
        view = anchor_view.extended(delta)       # shared immutable blocks
        res = incremental_additions(view, delta, semiring, base.values,
                                    base.parent, max_iters,
                                    track_parents=track_parents, seed=seed,
                                    fused_k=fused_k)
        host_sync(res.values)
        hop_stats.append(StreamStats(time.perf_counter() - t0,
                                     float(res.edge_work),
                                     int(res.iterations)))
        unstable_counts.append(int(res.unstable))
        results[wnd] = res.values
    return WindowSlideRun(results, anchor, base_stats, hop_stats,
                          time.perf_counter() - t_all,
                          _slide_added_edges(store, windows, anchor),
                          stable_milli=stable_fraction_milli(
                              unstable_counts, store.num_nodes))


def _launch_stats(t0: float, res, valid: int):
    """(StreamStats, per-valid-lane unstable counts) of one stacked launch:
    one host read of each per-lane statistic."""
    stats = StreamStats(time.perf_counter() - t0, float(res.edge_work.sum()),
                        int(res.iterations.max()))
    return stats, res.unstable[:valid].cpu().numpy()


def run_window_slide_batched(
    store: SnapshotStore,
    semiring: Semiring,
    source: int,
    width: int | None = None,
    *,
    windows: "list[Window] | None" = None,
    step: int = 1,
    start: int = 0,
    anchor: Window | None = None,
    max_iters: int = 10_000,
    cg_split: int = 1,
    track_parents: bool = False,
    seed: str = "instability",
    fused_k: int = 1,
) -> WindowSlideRun:
    """Batched window slide: every slide hop as a lane of ONE stacked
    launch (``_slide_launch``), the anchor state broadcast to all lanes."""
    t_all = time.perf_counter()
    windows, anchor = _resolve(store, width, windows, step, start, anchor)
    anchor_view, base, base_stats = _anchor_base(
        store, anchor, semiring, source, max_iters, cg_split, track_parents,
        fused_k)

    t0 = time.perf_counter()
    res, bucket = _slide_launch(store, semiring, anchor_view,
                                extract_state(base), windows, anchor,
                                max_iters=max_iters,
                                track_parents=track_parents, seed=seed,
                                fused_k=fused_k)
    stats, unstable = _launch_stats(t0, res, len(windows))
    results = {wnd: res.values[lane] for lane, wnd in enumerate(windows)}
    return WindowSlideRun(results, anchor, base_stats, [stats],
                          time.perf_counter() - t_all,
                          _slide_added_edges(store, windows, anchor),
                          [(len(windows), bucket)],
                          stable_milli=stable_fraction_milli(
                              unstable, store.num_nodes))


def _slide_launch(store: SnapshotStore, semiring: Semiring, anchor_view,
                  state: "QueryState | list[QueryState]",
                  windows: "list[Window]", anchor: Window,
                  *, max_iters: int, track_parents: bool,
                  lane_map: "list[int] | None" = None,
                  seed: str = "instability", fused_k: int = 1):
    """ONE stacked launch re-converging every window from anchor state(s).

    ``state`` is a single :class:`QueryState` broadcast to every window
    lane (``lane_map=None``), or a list of states with ``lane_map[k]``
    naming the state that seeds window lane ``k``. Masked padding lanes
    ride along as inert copies of the first mapped state: their Δ is
    all-sentinel and ``lane_valid`` zeroes them out of the work
    accounting. Returns ``(FixpointResult, bucket)``.
    """
    bucket = lane_bucket(len(windows), 1)
    stacked = store.slide_stack(windows, anchor, num_lanes=bucket)
    if lane_map is None:
        states, lane_map = [state], [0] * len(windows)
    else:
        states = list(state)
        if len(lane_map) != len(windows):
            raise ValueError(f"lane_map names {len(lane_map)} lanes for "
                             f"{len(windows)} windows")
    lane_map = list(lane_map) + [lane_map[0]] * (bucket - len(windows))
    values, parent = gather_lane_states(
        torch.stack([s.values for s in states]),
        torch.stack([s.parent for s in states]), lane_map)
    lane_valid = torch.arange(bucket, device=values.device) < len(windows)
    res = incremental_additions_batched(
        store.num_nodes, semiring, values, parent,
        shared_blocks=tuple(anchor_view.blocks), delta_blocks=(stacked,),
        max_iters=max_iters, track_parents=track_parents,
        seed_blocks=(stacked,), lane_valid=lane_valid, seed=seed,
        fused_k=fused_k)
    host_sync(res.values)
    return res, bucket


# ---------------------------------------------------------------------------
# Streaming slide campaigns: cross-launch incremental anchor maintenance.
# ---------------------------------------------------------------------------


def _validate_advancing(windows: "list[Window]", tail: Window | None = None):
    prev = tail
    for wnd in windows:
        i, j = wnd
        if j < i:
            raise ValueError(f"window {wnd} is empty: need i <= j")
        if prev is not None and (i < prev[0] or j < prev[1]):
            raise ValueError(
                f"windows must advance: {wnd} steps backwards from {prev} "
                "(both endpoints must be nondecreasing)")
        prev = wnd


#: ``campaign_width`` sentinel: let ``optimal_campaigns`` choose the
#: partition by Δ-volume instead of cutting fixed-width chunks.
CAMPAIGN_AUTO = "auto"

_STREAM_COUNTER = itertools.count()


def _valid_campaign_width(width) -> bool:
    return width == CAMPAIGN_AUTO or (isinstance(width, int) and width >= 1)


@dataclasses.dataclass
class WindowStream:
    """An advancing window sequence consumed campaign by campaign.

    Windows arrive in slide order (both endpoints nondecreasing,
    enforced), are buffered here, and each executor call drains the
    pending buffer as campaigns of ``campaign_width`` windows (``"auto"``:
    ``optimal_campaigns`` picks the partition). The stream holds no query
    state; anchors live in the store's "AS" family. ``name`` identifies the
    stream to an :class:`AnchorChain` (generated unless given).

    ``feed`` attaches a live window source (anything with ``poll()`` and
    ``advance_floor(lo)``): every ``pending``/``take``/``take_next`` first
    polls it for new windows, and every consumption reports the oldest
    snapshot an unconsumed window still needs.
    """

    campaign_width: "int | str"
    windows: "list[Window]" = dataclasses.field(default_factory=list)
    consumed: int = 0
    name: "str | None" = None
    feed: "object | None" = None

    def __post_init__(self):
        if not _valid_campaign_width(self.campaign_width):
            raise ValueError(
                f'campaign_width must be an int >= 1 or "auto", '
                f"got {self.campaign_width!r}")
        self.windows = [tuple(w) for w in self.windows]
        _validate_advancing(self.windows)
        if self.name is None:
            self.name = f"stream-{next(_STREAM_COUNTER)}"
        self._sync_feed()

    def _sync_feed(self) -> None:
        if self.feed is not None:
            born = self.feed.poll()
            if born:
                self.extend(born)

    def _report_feed(self) -> None:
        if self.feed is not None:
            rest = self.windows[self.consumed:]
            self.feed.advance_floor(rest[0][0] if rest else None)

    def extend(self, windows: "list[Window]") -> "WindowStream":
        """Append newly arrived windows (must keep the sequence advancing)."""
        windows = [tuple(w) for w in windows]
        _validate_advancing(windows,
                            tail=self.windows[-1] if self.windows else None)
        self.windows.extend(windows)
        return self

    def pending(self) -> "list[Window]":
        """Windows buffered but not yet consumed (polls the feed first)."""
        self._sync_feed()
        return self.windows[self.consumed:]

    def take(self) -> "list[Window]":
        """Drain and return the pending windows (executor entry point)."""
        out = self.pending()
        self.consumed = len(self.windows)
        self._report_feed()
        return out

    def take_next(self, count: int) -> "list[Window]":
        """Consume and return up to ``count`` pending windows."""
        self._sync_feed()
        out = self.windows[self.consumed:self.consumed + count]
        self.consumed += len(out)
        self._report_feed()
        return out


def stream_campaigns(windows: "list[Window]",
                     campaign_width: int) -> "list[list[Window]]":
    """Cut an advancing window sequence into consecutive fixed-width
    campaigns (the last may be short). The ``"auto"`` sentinel needs a
    store and is resolved by ``optimal_campaigns`` instead."""
    if campaign_width == CAMPAIGN_AUTO:
        raise ValueError(
            'campaign_width="auto" needs a SnapshotStore to plan against — '
            "partition via optimal_campaigns(store, windows), which is what "
            'run_window_stream_batched(campaign_width="auto") does')
    if not _valid_campaign_width(campaign_width):
        raise ValueError(f'campaign_width must be an int >= 1 or "auto", '
                         f"got {campaign_width!r}")
    return [windows[k:k + campaign_width]
            for k in range(0, len(windows), campaign_width)]


# ---------------------------------------------------------------------------
# Campaign planner: Δ-volume DP over the campaign partition.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CampaignPlan:
    """A campaign partition of an advancing window sequence + modeled cost.

    * ``slide_edges``: every window streams ``|T(window)| − |T(anchor)|``
      addition edges off its campaign anchor.
    * ``anchor_edges``: the first anchor's rebuild ``|T(anchor_0)|`` plus
      each later campaign's incremental hop (telescopes to
      ``|T(anchor_last)|`` undiscounted).
    * ``padding_edges``: each of a campaign's ``bucket − L`` masked lanes
      priced at the campaign's widest slide Δ.

    Every hop atom is discounted by ``stable_milli`` (‰ of vertex-lanes
    the stability analysis keeps out of the seed frontier), or priced by
    ``cost_model.hop_cost`` when a cost model is given.
    """

    campaigns: "list[list[Window]]"
    anchors: "list[Window]"              # per-campaign (lo_k, stream_hi)
    lane_budget: int
    data_extent: int
    slide_edges: int
    anchor_edges: int
    padding_edges: int
    # instability discount (‰ stable) the volumes above were priced under
    stable_milli: int = 0
    # duck-typed cost model (``hop_cost``/``anchor_cost``) the volumes were
    # priced under, or None for the raw discounted edge-count objective
    cost_model: object = None

    @property
    def widths(self) -> "list[int]":
        """Per-campaign window counts (the partition's shape)."""
        return [len(c) for c in self.campaigns]

    @property
    def total_edges(self) -> int:
        """The planner's objective: slide + anchor + masked-lane volume."""
        return self.slide_edges + self.anchor_edges + self.padding_edges


def _instability_volume(edges: int, stable_milli: int) -> int:
    """One Δ-volume atom discounted by the modeled stable fraction (‰),
    with floor division so the DP and the partition price stay equal."""
    if not 0 <= stable_milli <= 1000:
        raise ValueError(f"stable_milli must be in [0, 1000], "
                         f"got {stable_milli!r}")
    return edges * (1000 - stable_milli) // 1000


def campaign_volume(store: SnapshotStore, campaigns: "list[list[Window]]",
                    *, data_extent: int = 1,
                    lane_budget: "int | None" = None,
                    stable_milli: int = 0,
                    cost_model=None) -> CampaignPlan:
    """Price a campaign partition under the planner's Δ-volume model,
    anchoring each campaign at ``(campaign_lo, stream_hi)`` as the stream
    executor does. The first anchor's rebuild prices undiscounted (or via
    ``cost_model.anchor_cost``)."""
    if not campaigns or not all(campaigns):
        raise ValueError("campaigns must be a non-empty list of non-empty "
                         "window lists")
    windows = [w for c in campaigns for w in c]
    _validate_advancing(windows)
    stream_hi = windows[-1][1]
    anchors = [(c[0][0], stream_hi) for c in campaigns]
    if cost_model is not None:
        price = cost_model.hop_cost
        first_anchor = cost_model.anchor_cost(store.window_size(*anchors[0]))
    else:
        def price(edges):
            return _instability_volume(edges, stable_milli)
        first_anchor = store.window_size(*anchors[0])
    slide = padding = 0
    for campaign, anchor in zip(campaigns, anchors):
        deltas = [price(hop_added_edges(store, anchor, w)) for w in campaign]
        slide += sum(deltas)
        bucket = lane_bucket(len(campaign), data_extent)
        padding += (bucket - len(campaign)) * max(deltas)
    anchor_edges = first_anchor + sum(
        price(hop_added_edges(store, prev, cur))
        for prev, cur in zip(anchors, anchors[1:]))
    return CampaignPlan(campaigns, anchors,
                        lane_budget if lane_budget is not None
                        else max(map(len, campaigns)),
                        data_extent, slide, anchor_edges, padding,
                        stable_milli=stable_milli, cost_model=cost_model)


def optimal_campaigns(store: SnapshotStore, windows: "list[Window]", *,
                      lane_budget: int = 8,
                      data_extent: int = 1,
                      stable_milli: int = 0,
                      cost_model=None) -> CampaignPlan:
    """Δ-volume-minimal campaign partition: a suffix DP over cut points.

    .. code-block:: text

        f(N) = 0
        f(j) = min over i in (j, min(j+lane_budget, N)]:
                 slideΔ(j, i) + pad(j, i)
               + (|T(a_i)| − |T(a_j)|  if i < N) + f(i)
        total = |T(a_0)| + f(0)          # a_j = (lo_j, stream_hi)

    Every atom is priced as ``campaign_volume`` prices it, so the returned
    plan's ``total_edges`` is ≤ that of every fixed-width chunking with
    width ≤ ``lane_budget``.
    """
    windows = [tuple(w) for w in windows]
    if not windows:
        raise ValueError("need at least one window to plan campaigns")
    _validate_advancing(windows)
    if not isinstance(lane_budget, int) or lane_budget < 1:
        raise ValueError(f"lane_budget must be an int >= 1, "
                         f"got {lane_budget!r}")
    n = len(windows)
    stream_hi = windows[-1][1]
    anchor_size = [store.window_size(lo, stream_hi) for lo, _ in windows]
    window_size = [store.window_size(*w) for w in windows]
    if cost_model is not None:
        price = cost_model.hop_cost
    else:
        def price(edges):
            return _instability_volume(edges, stable_milli)

    f = [float("inf")] * n + [0.0]
    cut: "list[int]" = [0] * n
    for j in range(n - 1, -1, -1):
        slide, widest = 0, 0
        for i in range(j + 1, min(j + lane_budget, n) + 1):
            delta = price(window_size[i - 1] - anchor_size[j])
            slide += delta
            widest = max(widest, delta)
            lanes = i - j
            pad = (lane_bucket(lanes, data_extent) - lanes) * widest
            hop = (price(anchor_size[i] - anchor_size[j]) if i < n else 0)
            cost = slide + pad + hop + f[i]
            if cost < f[j]:
                f[j], cut[j] = cost, i
    campaigns = []
    j = 0
    while j < n:
        campaigns.append(windows[j:cut[j]])
        j = cut[j]
    return campaign_volume(store, campaigns, data_extent=data_extent,
                           lane_budget=lane_budget,
                           stable_milli=stable_milli, cost_model=cost_model)


def _stream_qkey(semiring: Semiring, source: int, max_iters: int,
                 cg_split: int, track_parents: bool) -> tuple:
    """Anchor-state cache key: everything that selects the query (values
    depend only on semiring and source; the rest is kept so cached parents
    match the options of the run that would have rebuilt the state)."""
    return (semiring.name, source, max_iters, cg_split, track_parents)


@dataclasses.dataclass
class WindowStreamRun:
    """Result record of a streamed run: per-window values, the campaign
    partition, per-campaign anchor events (rebuild/hop/hit) and stats,
    and, in campaign_width="auto" mode, the chosen CampaignPlan."""

    results: dict[Window, torch.Tensor]  # window -> values
    campaigns: "list[list[Window]]"
    anchors: "list[Window]"              # per-campaign anchor window
    # per-campaign anchor acquisition: "rebuild" (from-scratch fixpoint),
    # "hop" (incremental_additions from a cached covering state), or "hit"
    anchor_events: "list[str]"
    anchor_stats: "list[StreamStats]"    # per-campaign anchor acquisition
    hop_stats: "list[StreamStats]"       # per-campaign stacked launch
    wall_s: float
    added_edges: int                     # total window-hop Δ volume
    anchor_delta_edges: int              # Δ volume of incremental anchor hops
    lane_layout: "list[tuple[int, int]]"
    plan: "CampaignPlan | None" = None
    # measured stable fraction (‰) over all window hops (padding excluded)
    stable_milli: int = 0

    @property
    def anchor_rebuilds(self) -> int:
        """Count of from-scratch anchor fixpoints in this run."""
        return self.anchor_events.count("rebuild")

    @property
    def anchor_hops(self) -> int:
        """Count of incremental anchor hops in this run."""
        return self.anchor_events.count("hop")

    @property
    def anchor_hits(self) -> int:
        """Count of exact anchor cache hits (zero anchor work)."""
        return self.anchor_events.count("hit")


def _acquire_anchor_state(store: SnapshotStore, qkey: tuple, anchor: Window,
                          semiring: Semiring, source: int, max_iters: int,
                          cg_split: int, track_parents: bool,
                          seed: str = "instability", fused_k: int = 1):
    """Anchor state via cache hit, incremental hop, or from-scratch rebuild.

    Returns ``(anchor_view, state, stats, event, delta_edges)``. The view's
    blocks union to exactly T(anchor) on every path, and the acquired
    state is (re-)cached under the anchor's "AS" tag. ``fused_k`` shapes
    launches only, so it is not part of ``qkey``.
    """
    t0 = time.perf_counter()
    state = store.anchor_state_get(qkey, anchor)
    if state is not None:
        view = _anchor_view(store, anchor, cg_split)
        return view, state, StreamStats(time.perf_counter() - t0, 0.0, 0), \
            "hit", 0
    cover = store.anchor_state_cover(qkey, anchor)
    if cover is not None:
        cover_window, cover_state = cover
        delta = store.delta_block(cover_window, anchor)
        view = _anchor_view(store, cover_window, cg_split).extended(delta)
        res = incremental_additions(view, delta, semiring, cover_state.values,
                                    cover_state.parent, max_iters,
                                    track_parents=track_parents, seed=seed,
                                    fused_k=fused_k)
        host_sync(res.values)
        state = store.anchor_state_put(qkey, anchor, extract_state(res))
        delta_edges = (store.window_size(*anchor)
                       - store.window_size(*cover_window))
        return view, state, StreamStats(time.perf_counter() - t0,
                                        float(res.edge_work),
                                        int(res.iterations)), "hop", \
            delta_edges
    anchor_view, base, base_stats = _anchor_base(
        store, anchor, semiring, source, max_iters, cg_split, track_parents,
        fused_k)
    state = store.anchor_state_put(qkey, anchor, extract_state(base))
    return anchor_view, state, base_stats, "rebuild", 0


# ---------------------------------------------------------------------------
# Anchor chains: overlapping streams sharing one anchor-state sequence.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AnchorChain:
    """A named, refcounted chain of nested anchor states shared by streams.

    * **Registration.** Streams :meth:`register` by name; a stream run
      with ``chain=`` records every anchor it acquires as a link
      (:meth:`observe`) and reports its progress (:meth:`advance`).
    * **Pinning.** A link is pinned in the store while ANY registered
      stream is still behind it (its last anchor-lo has not passed the
      link's lo). Once every registered stream has passed a link it is
      pruned and its state returns to the LRU. With no stream registered
      the links stay listed, unpinned, for :func:`select_chain`.
    * **Cover.** :meth:`cover` is the tightest link covering a window.

    Pinning never changes values, only whether a lagging stream pays a
    hit/hop or a rebuild. The chain binds to the first query key it
    serves; a different key raises.
    """

    store: SnapshotStore
    name: str = "chain"
    qkey: "tuple | None" = None
    links: "list[Window]" = dataclasses.field(default_factory=list)
    _positions: "dict[str, int | None]" = dataclasses.field(
        default_factory=dict)
    _pinned: "set[Window]" = dataclasses.field(default_factory=set)

    def bind(self, qkey: tuple) -> "AnchorChain":
        """Bind the chain to a query key (first use wins, mismatch raises)."""
        if self.qkey is None:
            self.qkey = qkey
        elif self.qkey != qkey:
            raise ValueError(
                f"chain {self.name!r} is bound to query key {self.qkey!r}; "
                f"a stream with query key {qkey!r} cannot share it")
        return self

    @staticmethod
    def _member(stream: "WindowStream | str") -> str:
        return stream if isinstance(stream, str) else stream.name

    def register(self, stream: "WindowStream | str") -> "AnchorChain":
        """Add a stream (idempotent); pins every current link until the
        stream advances past it."""
        name = self._member(stream)
        if name not in self._positions:
            self._positions[name] = None   # behind everything
            self._repin()
        return self

    def unregister(self, stream: "WindowStream | str") -> None:
        """Remove a stream; links only it was behind unpin."""
        name = self._member(stream)
        if name not in self._positions:
            raise ValueError(f"stream {name!r} is not registered with "
                             f"chain {self.name!r}")
        del self._positions[name]
        self._repin()

    def registered(self) -> "list[str]":
        """Names of currently registered streams, sorted."""
        return sorted(self._positions)

    def cover(self, window: Window) -> "Window | None":
        """Tightest chain link whose interval covers ``window`` (else None)."""
        return tightest_cover(self.links, tuple(window),
                              self.store.window_size)

    def observe(self, anchor: Window) -> None:
        """Record an acquired anchor state as a chain link."""
        anchor = tuple(anchor)
        if anchor not in self.links:
            self.links.append(anchor)
            self.links.sort(key=lambda w: (w[0], -w[1]))
            self._repin()

    def advance(self, stream: "WindowStream | str", anchor: Window) -> None:
        """Report a stream's last consumed anchor; passed links unpin."""
        name = self._member(stream)
        if name not in self._positions:
            raise ValueError(f"stream {name!r} is not registered with "
                             f"chain {self.name!r}")
        self._positions[name] = anchor[0]
        self._repin()

    def _repin(self) -> None:
        """Reconcile store pins with the is-any-stream-behind rule, pruning
        links every registered stream has passed."""
        want = set()
        if self._positions:
            positions = list(self._positions.values())
            want = {link for link in self.links
                    if any(pos is None or pos <= link[0]
                           for pos in positions)}
            self.links = [link for link in self.links if link in want]
        for link in want - self._pinned:
            self.store.pin(anchor_tag(self.qkey, link))
        for link in self._pinned - want:
            self.store.unpin(anchor_tag(self.qkey, link))
        self._pinned = want


def select_chain(chains: "list[AnchorChain]", window: Window,
                 qkey: "tuple | None" = None) -> "AnchorChain | None":
    """The chain (optionally filtered to a query key) holding the
    largest-|T| link covering ``window``; None when no chain covers it."""
    best, best_size = None, -1
    for chain in chains:
        if qkey is not None and chain.qkey is not None and chain.qkey != qkey:
            continue
        link = chain.cover(window)
        if link is not None:
            size = chain.store.window_size(*link)
            if size > best_size:
                best, best_size = chain, size
    return best


def run_window_stream_batched(
    store: SnapshotStore,
    semiring: Semiring,
    source: int,
    width: int | None = None,
    *,
    windows: "list[Window] | None" = None,
    stream: WindowStream | None = None,
    step: int = 1,
    start: int = 0,
    campaign_width: "int | str | None" = None,
    lane_budget: int = 8,
    chain: "AnchorChain | None" = None,
    max_iters: int = 10_000,
    cg_split: int = 1,
    track_parents: bool = False,
    seed: str = "instability",
    stable_milli: int = 0,
    cost_model=None,
    fused_k: int = 1,
) -> WindowStreamRun:
    """Streaming slide campaigns with incremental anchor maintenance.

    Consumes an advancing window sequence (``stream.take()``, an explicit
    ``windows`` list, or a ``slide_windows`` plan from ``width``), cuts it
    into campaigns of ``campaign_width`` windows (default 4; a
    ``WindowStream`` carries its own width) or, with ``"auto"``, the
    ``optimal_campaigns`` partition capped at ``lane_budget`` windows
    (priced with the ``stable_milli`` hint, or by ``cost_model``), and runs
    each campaign as ONE masked pow2-lane launch (``_slide_launch``).

    Campaign k anchors at ``(lo_k, stream_hi)``; its state is a cache hit,
    an incremental hop off the tightest cached cover, or a rebuild.
    ``chain=`` (requires ``stream=``) shares anchor states across
    overlapping streams via an :class:`AnchorChain`. Values equal
    ``run_window_slide_batched`` run cold per campaign, bit for bit.
    """
    t_all = time.perf_counter()
    if stream is not None:
        if windows is not None or width is not None:
            raise ValueError("pass stream= alone, not with width=/windows=")
        if campaign_width is not None:
            raise ValueError("campaign_width= conflicts with stream=: the "
                             "WindowStream carries its own campaign width")
        windows = stream.take()
        campaign_width = stream.campaign_width
    else:
        if chain is not None:
            raise ValueError("chain= requires stream=: an AnchorChain tracks "
                             "named WindowStreams, so anonymous window lists "
                             "cannot register against one")
        if campaign_width is None:
            campaign_width = 4
        if windows is None:
            if width is None:
                raise ValueError("pass width=, windows= or stream=")
            windows = slide_windows(store.seq.num_snapshots, width, step=step,
                                    start=start)
        windows = [tuple(w) for w in windows]
        _validate_advancing(windows)
    qkey = _stream_qkey(semiring, source, max_iters, cg_split, track_parents)
    if chain is not None:
        if chain.store is not store:
            raise ValueError("chain= must share the run's SnapshotStore — "
                             "anchor states live in the store's AS family")
        chain.bind(qkey).register(stream)
    if not windows:
        return WindowStreamRun({}, [], [], [], [], [],
                               time.perf_counter() - t_all, 0, 0, [])
    plan = None
    if campaign_width == CAMPAIGN_AUTO:
        plan = optimal_campaigns(store, windows, lane_budget=lane_budget,
                                 stable_milli=stable_milli,
                                 cost_model=cost_model)
        campaigns = plan.campaigns
    else:
        campaigns = stream_campaigns(windows, campaign_width)
    stream_hi = windows[-1][1]

    results: dict[Window, torch.Tensor] = {}
    anchors: "list[Window]" = []
    anchor_events: "list[str]" = []
    anchor_stats: "list[StreamStats]" = []
    hop_stats: "list[StreamStats]" = []
    lane_layout: "list[tuple[int, int]]" = []
    added_edges = 0
    anchor_delta_edges = 0
    unstable_counts: "list[np.ndarray]" = []
    for campaign in campaigns:
        anchor = (min(i for i, _ in campaign), stream_hi)
        anchor_view, state, stats, event, delta_edges = _acquire_anchor_state(
            store, qkey, anchor, semiring, source, max_iters, cg_split,
            track_parents, seed=seed, fused_k=fused_k)
        if chain is not None:
            chain.observe(anchor)   # pin before any later put can evict it
        anchors.append(anchor)
        anchor_events.append(event)
        anchor_stats.append(stats)
        anchor_delta_edges += delta_edges
        t0 = time.perf_counter()
        res, bucket = _slide_launch(store, semiring, anchor_view, state,
                                    campaign, anchor, max_iters=max_iters,
                                    track_parents=track_parents, seed=seed,
                                    fused_k=fused_k)
        launch_stats, unstable = _launch_stats(t0, res, len(campaign))
        hop_stats.append(launch_stats)
        lane_layout.append((len(campaign), bucket))
        unstable_counts.append(unstable)
        for lane, wnd in enumerate(campaign):
            results[wnd] = res.values[lane]
        added_edges += _slide_added_edges(store, campaign, anchor)
        if chain is not None:
            chain.advance(stream, anchor)   # links all streams passed unpin
    return WindowStreamRun(results, campaigns, anchors, anchor_events,
                           anchor_stats, hop_stats,
                           time.perf_counter() - t_all, added_edges,
                           anchor_delta_edges, lane_layout, plan,
                           stable_milli=stable_fraction_milli(
                               np.concatenate(unstable_counts),
                               store.num_nodes))

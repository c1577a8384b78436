"""Always-on query service: many clients, one evolving graph (PyTorch port
of ``repro.core.service``; scheduling and packing are host code copied
from the reference, without its ``gated=`` option). With ``mesh=``
(launch/mesh.py) every packed launch's lanes split over a ``data`` mesh.

A long-lived :class:`QueryService` accepts an open-loop stream of
heterogeneous window queries (mixed sources, semirings, window extents)
from many registered clients and answers them with the batched window
machinery of core/window.py:

* **Admission / batching (the packer).** Each scheduler turn collects at
  most one campaign's worth of pending windows per client, groups them by
  identical launch options ``(semiring, max_iters, cg_split,
  track_parents, fused_k)`` and the same pow2 slide-Δ width bucket, and
  runs each group as ONE ``_slide_launch``: every client's windows become
  lanes of a single masked pow2-lane relax launch (``lane_map`` seeds each
  lane from its own query's anchor state). Results never depend on which
  queries shared a launch: each lane converges over exactly its window's
  common graph to the unique fixpoint.
* **Round-robin scheduling (no starvation).** A turn walks the registry
  from a rotating pointer, draws ≤ ``campaign_width`` windows from each
  ready client and stops adding clients once ``turn_budget`` lanes are
  reached, but always serves the first ready client, so any ready client
  is served within ``len(clients)`` turns.
* **Shared anchor state.** Per query key the service keeps one
  :class:`AnchorChain`; every launch acquires its anchor states through
  the store's "AS" cache (hit / hop / rebuild), records them as chain
  links and reports per-client progress, so clients with the same query
  do fewer rebuilds than solo runs, with bit-identical values.

The scheduling loop never syncs per query: the one host sync per packed
launch is inside ``_slide_launch``, and the launch's statistics are read
after it. Scheduling decisions are count-based, never wall-clock-based,
so launch composition and every count in :class:`ServiceMetrics` are
machine-independent; wall-clock feeds only throughput and latency.
"""

from __future__ import annotations

import dataclasses
import itertools
import time

import torch

from repro_torch.core.snapshots import SnapshotStore
from repro_torch.core.trigrid import hop_added_edges
from repro_torch.core.window import (
    CAMPAIGN_AUTO,
    AnchorChain,
    Window,
    WindowStream,
    _acquire_anchor_state,
    _slide_launch,
    _stream_qkey,
)
from repro_torch.graph.semiring import Semiring

_CLIENT_COUNTER = itertools.count()


@dataclasses.dataclass
class ServiceClient:
    """One registered client: a named WindowStream plus its query options.

    Created by :meth:`QueryService.register`. The client owns the
    admitted-window buffer (``stream``), the completed results
    (``results``: window → converged values, a tensor on the store's
    device) and its admission→completion latencies; the service owns
    scheduling. ``horizon`` is the last snapshot the client may query
    (default: the store's final snapshot); launch anchors widen to it, so
    successive anchors stay nested. A live ``feed``
    (``ingest.LiveWindowFeed``) makes the horizon grow with the cuts.
    """

    name: str
    semiring: Semiring
    source: int
    stream: WindowStream
    horizon: int
    max_iters: int = 10_000
    cg_split: int = 1
    track_parents: bool = False
    # fused-chunk size of every launch serving this client: a launch
    # option (same results at any value), so it joins the admission key
    # but not the anchor-state qkey
    fused_k: int | None = None
    feed: "object | None" = None
    results: "dict[Window, torch.Tensor]" = dataclasses.field(
        default_factory=dict)
    latencies_s: "list[float]" = dataclasses.field(default_factory=list)
    campaigns_done: int = 0
    _arrived: "dict[Window, float]" = dataclasses.field(default_factory=dict)

    @property
    def qkey(self) -> tuple:
        """The anchor-state cache key selecting this client's query;
        clients with equal keys share anchor states and one chain."""
        return _stream_qkey(self.semiring, self.source, self.max_iters,
                            self.cg_split, self.track_parents)

    def pending(self) -> "list[Window]":
        """Windows admitted but not yet answered."""
        return self.stream.pending()


@dataclasses.dataclass
class LaunchRecord:
    """Accounting for one packed batched launch.

    ``windows``/``clients`` are lane-parallel. ``anchor_events`` holds one
    hit/hop/rebuild event per distinct query key in the launch, in first-
    appearance order. ``lanes`` counts valid lanes; ``bucket`` is the pow2
    lane count launched (``bucket - lanes`` masked lanes).
    """

    group: tuple                 # admission compatibility key
    anchor: Window
    windows: "list[Window]"
    clients: "list[str]"         # client name per lane
    lanes: int
    bucket: int
    anchor_events: "list[str]"   # per distinct qkey: "hit"/"hop"/"rebuild"
    edge_work: float
    iterations: int


@dataclasses.dataclass
class ServiceMetrics:
    """Aggregate service counters plus derived throughput/latency.

    Count fields are deterministic for a fixed load; wall-clock enters
    only through ``wall_s``/``latencies_s`` and the derived ratios.
    """

    admitted: int = 0
    completed: int = 0
    turns: int = 0
    launches: int = 0
    lanes: int = 0
    padded_lanes: int = 0
    anchor_rebuilds: int = 0
    anchor_hops: int = 0
    anchor_hits: int = 0
    edge_work: float = 0.0
    # stability accounting over every packed launch's valid lanes:
    # seeded_vertex_lanes = Σ lanes·num_nodes, unstable_vertex_lanes =
    # Σ per-lane |instability seed set| (graph/stability.py)
    seeded_vertex_lanes: int = 0
    unstable_vertex_lanes: int = 0
    wall_s: float = 0.0
    latencies_s: "list[float]" = dataclasses.field(default_factory=list)

    @property
    def batch_occupancy(self) -> float:
        """Mean valid lanes per packed launch (> 1 ⇔ packing coalesced)."""
        return self.lanes / self.launches if self.launches else 0.0

    @property
    def stable_fraction_milli(self) -> int:
        """Measured stable fraction (‰) over all served window lanes (0
        before any launch)."""
        if not self.seeded_vertex_lanes:
            return 0
        return round(1000 * (self.seeded_vertex_lanes
                             - self.unstable_vertex_lanes)
                     / self.seeded_vertex_lanes)

    @property
    def queries_per_sec(self) -> float:
        """Completed window queries per wall-clock second of turn time."""
        return self.completed / self.wall_s if self.wall_s > 0 else 0.0

    def latency_us(self, q: float) -> float:
        """Admission→completion latency percentile ``q`` in [0, 100], µs
        (nearest rank; 0.0 before any completion)."""
        if not self.latencies_s:
            return 0.0
        xs = sorted(self.latencies_s)
        rank = max(1, -(-int(q * len(xs)) // 100))  # ceil(q/100 * n), >= 1
        return xs[min(rank, len(xs)) - 1] * 1e6


def _width_bucket(edges: int) -> int:
    """Pow2 ceiling of a slide-Δ edge count (0 buckets as 1)."""
    b = 1
    while b < edges:
        b *= 2
    return b


class QueryService:
    """Long-lived multi-client query service over one evolving graph.

    Lifecycle: :meth:`register` clients, :meth:`submit` windows as they
    arrive, call :meth:`turn` per scheduling tick (or :meth:`drain` until
    every admitted window is answered), then :meth:`unregister` finished
    clients so their anchor-chain pins release.

    ``lane_budget`` caps valid lanes per packed launch (campaigns never
    split). ``turn_budget`` caps lanes drawn per turn (None = unbounded);
    at least one ready client is served per turn regardless. ``seed`` is
    the frontier-seeding mode of every launch and anchor hop
    (``"instability"`` or ``"delta"``; same values either way). ``mesh``
    (a ``data`` mesh, launch/mesh.py) splits every packed launch's lanes
    over its devices; the lanes then bucket to ``lane_bucket(lanes,
    data_extent)`` (``LaunchRecord.bucket``) and results still come back
    on the store's device.
    """

    def __init__(self, store: SnapshotStore, *, lane_budget: int = 8,
                 turn_budget: "int | None" = None, mesh=None,
                 seed: str = "instability"):
        if lane_budget < 1:
            raise ValueError(f"lane_budget must be >= 1, got {lane_budget}")
        if turn_budget is not None and turn_budget < 1:
            raise ValueError(f"turn_budget must be >= 1, got {turn_budget}")
        self.store = store
        self.lane_budget = lane_budget
        self.turn_budget = turn_budget
        self.mesh = mesh
        self.seed = seed
        self.clients: "list[ServiceClient]" = []
        self.launch_log: "list[LaunchRecord]" = []
        self._metrics = ServiceMetrics()
        self._chains: "dict[tuple, AnchorChain]" = {}
        self._rr = 0   # rotation pointer: index of the next client to serve

    def register(self, semiring: Semiring, source: int, *,
                 campaign_width: int = 4, name: "str | None" = None,
                 horizon: "int | None" = None, max_iters: int = 10_000,
                 cg_split: int = 1, track_parents: bool = False,
                 fused_k: int | None = None,
                 feed: "object | None" = None) -> ServiceClient:
        """Add a client; returns its :class:`ServiceClient` handle.

        ``campaign_width`` (int, ≤ ``lane_budget``) bounds the windows
        drawn from this client per turn; the ``"auto"`` planner is the solo
        streams' mode and is refused. The client joins the
        :class:`AnchorChain` of its query key. ``fused_k`` is the launch's
        fused-chunk size (clients pack together only when it matches).
        ``feed`` attaches a live window source polled every turn; its
        compaction floor follows this client's progress and is withdrawn at
        :meth:`unregister`.
        """
        if campaign_width == CAMPAIGN_AUTO:
            raise ValueError(
                'campaign_width="auto" is the solo planner\'s mode '
                "(run_window_stream_batched); the service schedules "
                "count-based turns — pass an int campaign width")
        if not isinstance(campaign_width, int) or campaign_width < 1:
            raise ValueError(
                f"campaign_width must be an int >= 1, got {campaign_width!r}")
        if campaign_width > self.lane_budget:
            raise ValueError(
                f"campaign_width {campaign_width} exceeds the service "
                f"lane_budget {self.lane_budget}: one campaign must fit "
                "in one launch")
        if name is None:
            name = f"client-{next(_CLIENT_COUNTER)}"
        if any(c.name == name for c in self.clients):
            raise ValueError(f"client name {name!r} is already registered")
        if horizon is None:
            horizon = self.store.seq.num_snapshots - 1
        client = ServiceClient(
            name=name, semiring=semiring, source=source,
            stream=WindowStream(campaign_width, name=name), horizon=horizon,
            max_iters=max_iters, cg_split=cg_split,
            track_parents=track_parents, fused_k=fused_k, feed=feed)
        chain = self._chains.setdefault(
            client.qkey,
            AnchorChain(self.store, name=f"svc-chain-{len(self._chains)}"))
        chain.bind(client.qkey).register(client.stream)
        self.clients.append(client)
        return client

    def submit(self, client: ServiceClient, windows: "list[Window]") -> int:
        """Admit newly arrived windows for ``client``; returns the count.

        Windows must keep the client's sequence advancing and end at or
        before its ``horizon``.
        """
        windows = [tuple(w) for w in windows]
        for wnd in windows:
            if wnd[1] > client.horizon:
                raise ValueError(
                    f"window {wnd} ends past client {client.name!r}'s "
                    f"horizon {client.horizon}")
        client.stream.extend(windows)
        now = time.perf_counter()
        for wnd in windows:
            client._arrived[wnd] = now
        self._metrics.admitted += len(windows)
        return len(windows)

    def unregister(self, client: ServiceClient) -> None:
        """Withdraw a drained client; its anchor-chain pins release and
        its feed's floor is withdrawn. Raises if windows are pending."""
        if client.pending():
            raise ValueError(
                f"client {client.name!r} still has {len(client.pending())} "
                "pending windows — drain before unregistering")
        self._chains[client.qkey].unregister(client.stream)
        if client.feed is not None:
            client.feed.close()
        self.clients.remove(client)
        if self.clients:
            self._rr %= len(self.clients)
        else:
            self._rr = 0

    def pending(self) -> int:
        """Total windows admitted but not yet answered, across clients."""
        return sum(len(c.stream.pending()) for c in self.clients)

    def turn(self) -> "list[LaunchRecord]":
        """One scheduler turn: poll feeds → select → pack → launch.

        Returns this turn's :class:`LaunchRecord`\\ s (empty when no
        client had pending work; an idle turn is not counted).
        """
        self._poll_feeds()
        t0 = time.perf_counter()
        selected = self._select()
        if not selected:
            return []
        records = [self._packed_launch(group, chunk)
                   for group, chunk in self._pack(selected)]
        self._metrics.turns += 1
        self._metrics.wall_s += time.perf_counter() - t0
        self._report_feeds()
        return records

    def drain(self, max_turns: int = 10_000) -> ServiceMetrics:
        """Run turns until no admitted window is unanswered; returns the
        metrics. Raises ``RuntimeError`` past ``max_turns`` turns."""
        turns = 0
        self._poll_feeds()
        while self.pending():
            self.turn()
            turns += 1
            if turns > max_turns:
                raise RuntimeError(
                    f"service failed to drain within {max_turns} turns")
        return self.metrics()

    def metrics(self) -> ServiceMetrics:
        """The service's live :class:`ServiceMetrics` accumulator."""
        return self._metrics

    # -- scheduling internals -------------------------------------------------

    def _poll_feeds(self) -> int:
        """Admit windows born from live feeds since the last poll, widening
        each feed client's ``horizon`` to its newest born snapshot."""
        admitted = 0
        for client in self.clients:
            if client.feed is None:
                continue
            born = client.feed.poll()
            if born:
                client.horizon = max(client.horizon,
                                     max(w[1] for w in born))
                admitted += self.submit(client, born)
        return admitted

    def _report_feeds(self) -> None:
        """Advance live feeds' compaction floors to each client's first
        unconsumed window low (``None`` = fully drained)."""
        for client in self.clients:
            if client.feed is None:
                continue
            rest = client.stream.pending()
            client.feed.advance_floor(rest[0][0] if rest else None)

    def _select(self) -> "list[tuple[ServiceClient, list[Window]]]":
        """Round-robin draw: ≤ one campaign per ready client, ≤ turn_budget
        lanes per turn, always ≥ 1 ready client served."""
        n = len(self.clients)
        start = self._rr
        picked: "list[tuple[ServiceClient, list[Window]]]" = []
        lanes = 0
        for k in range(n):
            idx = (start + k) % n
            client = self.clients[idx]
            pend = client.stream.pending()
            if not pend:
                continue
            width = min(client.stream.campaign_width, len(pend))
            if picked and self.turn_budget is not None \
                    and lanes + width > self.turn_budget:
                # budget reached: the cut client leads the next turn
                self._rr = idx
                return picked
            picked.append((client, client.stream.take_next(width)))
            lanes += width
            self._rr = (idx + 1) % n
        return picked

    def _pack(self, selected):
        """Group compatible campaigns into launches (the admission layer).

        Compatibility = identical launch options (semiring, max_iters,
        cg_split, track_parents, fused_k) AND equal pow2 width bucket of
        the campaign's largest slide-Δ, priced by ``hop_added_edges``
        against the group's provisional shared anchor. Groups chunk at
        ``lane_budget`` lanes; campaigns never split. Deterministic: group
        order is sorted, member order follows the rotation draw.
        """
        by_options: dict = {}
        for client, campaign in selected:
            okey = (client.semiring.name, client.max_iters, client.cg_split,
                    client.track_parents, client.fused_k)
            by_options.setdefault(okey, []).append((client, campaign))
        launches = []
        for okey in sorted(by_options):
            entries = by_options[okey]
            coarse = (min(w[0] for _, c in entries for w in c),
                      max(cl.horizon for cl, _ in entries))
            by_bucket: dict = {}
            for client, campaign in entries:
                widest = max(hop_added_edges(self.store, coarse, w)
                             for w in campaign)
                by_bucket.setdefault(_width_bucket(widest), []).append(
                    (client, campaign))
            for bkey in sorted(by_bucket):
                group_key = (okey[0], bkey)
                chunk: list = []
                lanes = 0
                for client, campaign in by_bucket[bkey]:
                    if chunk and lanes + len(campaign) > self.lane_budget:
                        launches.append((group_key, chunk))
                        chunk, lanes = [], 0
                    chunk.append((client, campaign))
                    lanes += len(campaign)
                if chunk:
                    launches.append((group_key, chunk))
        return launches

    def _packed_launch(self, group: tuple, chunk) -> LaunchRecord:
        """Run one compatibility group as ONE batched launch.

        Acquires anchor state per distinct query key (hit/hop/rebuild via
        the "AS" cache), records chain links and progress, maps each lane
        to its query's state (``lane_map``) and hands results and
        latencies back to the owning clients. ``_slide_launch`` makes the
        launch's one host sync; its statistics are read after it.
        """
        anchor = (min(w[0] for _, campaign in chunk for w in campaign),
                  max(client.horizon for client, _ in chunk))
        states: list = []
        state_idx: "dict[tuple, int]" = {}
        events: "list[str]" = []
        anchor_view = None
        for client, _ in chunk:
            qkey = client.qkey
            if qkey in state_idx:
                continue
            view, state, stats, event, _delta = _acquire_anchor_state(
                self.store, qkey, anchor, client.semiring, client.source,
                client.max_iters, client.cg_split, client.track_parents,
                seed=self.seed, fused_k=client.fused_k)
            self._chains[qkey].observe(anchor)  # pin before later puts evict
            state_idx[qkey] = len(states)
            states.append(state)
            events.append(event)
            if anchor_view is None:
                anchor_view = view
            self._metrics.edge_work += stats.edge_work
            if event == "rebuild":
                self._metrics.anchor_rebuilds += 1
            elif event == "hop":
                self._metrics.anchor_hops += 1
            else:
                self._metrics.anchor_hits += 1
        windows: "list[Window]" = []
        owners: "list[ServiceClient]" = []
        lane_map: "list[int]" = []
        for client, campaign in chunk:
            for wnd in campaign:
                windows.append(wnd)
                owners.append(client)
                lane_map.append(state_idx[client.qkey])
        lead = chunk[0][0]
        res, bucket = _slide_launch(
            self.store, lead.semiring, anchor_view, states, windows, anchor,
            max_iters=lead.max_iters, track_parents=lead.track_parents,
            mesh=self.mesh, lane_map=lane_map, seed=self.seed,
            fused_k=lead.fused_k)
        done = time.perf_counter()
        for lane, (wnd, client) in enumerate(zip(windows, owners)):
            client.results[wnd] = res.values[lane]
            latency = done - client._arrived.pop(wnd, done)
            client.latencies_s.append(latency)
            self._metrics.latencies_s.append(latency)
        for client, campaign in chunk:
            client.campaigns_done += 1
            self._chains[client.qkey].advance(client.stream, anchor)
        # padding lanes hold 0 work; the lanes' float32 sum is exact below
        # 2^24, as in the window executors (_launch_stats)
        work = float(res.edge_work.sum())
        self._metrics.launches += 1
        self._metrics.lanes += len(windows)
        self._metrics.padded_lanes += bucket - len(windows)
        self._metrics.completed += len(windows)
        self._metrics.edge_work += work
        self._metrics.seeded_vertex_lanes += len(windows) * self.store.num_nodes
        self._metrics.unstable_vertex_lanes += int(
            res.unstable[:len(windows)].sum())
        record = LaunchRecord(
            group=group, anchor=anchor, windows=windows,
            clients=[c.name for c in owners], lanes=len(windows),
            bucket=bucket, anchor_events=events, edge_work=work,
            iterations=int(res.iterations.max()))
        self.launch_log.append(record)
        return record

"""Live ingestion: snapshots born from an edge firehose (PyTorch port of
``repro.core.ingest``; host numpy, the algorithms copied as they are).

A stream of edge **events** arrives and snapshots are *cut* from it:

* :class:`EdgeLog` — the append-only event log. ``append(src, dst, w,
  op, ts)`` records add/delete events with bounded-buffer backpressure
  (``max_pending_events`` + a block/drop/spill policy, all metered in
  :class:`IngestMetrics`).
* :class:`Watermark` — visibility control. ``advance(ts)`` moves the
  watermark monotonically; ``cut()`` consumes every buffered event at or
  below it (in timestamp order, last-op-wins per edge) and materializes
  ONE new snapshot + canonical Δ-batch pair into the
  :class:`~repro_torch.core.snapshots.SnapshotStore` via
  ``SnapshotStore.ingest_cut``.
* **Online common-graph maintenance.** ``T(lo, k+1) = T(lo, k) ∖ dels_k``
  (a cut's applied additions are disjoint from the previous snapshot, so
  they never enter the intersection): each cut shrinks the running common
  graph by its deletions, metered as ``common_shrinkage``, and the
  intersection is installed in the store's window cache.
* :class:`LiveSequence` — the mutable counterpart of ``EvolvingSequence``
  a live store grows over; weights are the same pure key hash
  (``edge_weights``), so a replayed trace is bit-identical to its
  precomputed sequence.
* :class:`LiveWindowFeed` — emits each slide window the moment its last
  snapshot is cut, for a ``WindowStream(feed=...)`` or a ``QueryService``
  client, and registers a compaction floor for the snapshots its pending
  windows still need.
* :func:`events_from_sequence` / :func:`replay_events` — seeded trace
  replay: flatten an ``EvolvingSequence`` into events and drive log →
  watermark → cuts, one snapshot per distinct timestamp.

Retirement is the inverse of birth: ``SnapshotStore.compact`` (driven via
:meth:`Watermark.compact`) retires snapshots that have fallen out of every
registered floor and every pinned "AS" anchor.

Every event is one Python object, as in the reference: ingestion runs on
the host, in time linear in the events.
"""

# The reference's graphlint rule G009 sanctions ingest_cut calls and
# appends to a live sequence's arrays by the dotted name repro.core.ingest
# only, so it is off here; the port's own rule T009 (repro_torch.analysis)
# holds this module instead (the only ingest_cut caller is Watermark.cut,
# as there).
# graphlint: disable-file=G009

from __future__ import annotations

import dataclasses
import itertools
from typing import NamedTuple

import numpy as np

from repro_torch.core.snapshots import SnapshotStore
from repro_torch.graph.edgeset import (
    edge_keys,
    isin_sorted,
    keys_to_edges,
    merge_changes,
)
from repro_torch.graph.generators import edge_weights

#: Legal event operations.
OPS = ("add", "del")

#: Legal backpressure policies for a bounded :class:`EdgeLog`.
POLICIES = ("block", "drop", "spill")

_FEED_COUNTER = itertools.count()


class BackpressureStall(RuntimeError):
    """Raised by ``EdgeLog.append`` under the ``"block"`` policy when the
    pending buffer is full — the producer must cut (or drop) before
    appending more. Each raise is metered as one ``stalls``."""


class EdgeEvent(NamedTuple):
    """One immutable edge event: ``(ts, src, dst, op, w)``.

    ``op`` is ``"add"`` or ``"del"``; ``w`` is an optional payload weight
    kept for provenance — blocks derive weights from the edge key.
    """

    ts: int
    src: int
    dst: int
    op: str = "add"
    w: "float | None" = None


@dataclasses.dataclass
class IngestMetrics:
    """Ingestion counters shared by one log/watermark pair; every field is
    a deterministic integer for a fixed event trace (``events`` accepted,
    ``late_events`` rejected, backpressure ``stalls``/``dropped``/
    ``spilled``, ``cuts``, ``applied_additions``/``applied_deletions``,
    ``redundant_events``, ``common_shrinkage``, and the compaction trio)."""

    events: int = 0
    late_events: int = 0
    stalls: int = 0
    dropped: int = 0
    spilled: int = 0
    cuts: int = 0
    applied_additions: int = 0
    applied_deletions: int = 0
    redundant_events: int = 0
    common_shrinkage: int = 0
    compactions: int = 0
    retired_snapshots: int = 0
    freed_edges: int = 0


@dataclasses.dataclass
class LiveSequence:
    """A mutable evolving sequence a live ``SnapshotStore`` grows over.

    Duck-types ``EvolvingSequence`` (``num_nodes``, ``snapshot_keys``,
    ``additions``, ``deletions``, ``weights_for``, ``num_snapshots``) with
    lists that ``append`` extends. Compaction may replace retired entries
    with ``None``; absolute snapshot indices never shift.
    """

    num_nodes: int
    snapshot_keys: "list[np.ndarray | None]" = dataclasses.field(
        default_factory=list)
    additions: "list[np.ndarray | None]" = dataclasses.field(
        default_factory=list)
    deletions: "list[np.ndarray | None]" = dataclasses.field(
        default_factory=list)
    weight_seed: int = 0

    @property
    def num_snapshots(self) -> int:
        """Snapshots cut so far (compaction never shrinks this)."""
        return len(self.snapshot_keys)

    def weights_for(self, keys: np.ndarray) -> np.ndarray:
        """Per-edge weights: the same pure key hash as EvolvingSequence."""
        return edge_weights(keys, self.weight_seed)

    def append(self, keys: np.ndarray, added: np.ndarray,
               deleted: np.ndarray) -> int:
        """Append one cut snapshot + its transition Δ pair; returns its
        index. The first snapshot records no transition, so
        ``len(additions) == num_snapshots - 1`` as in ``EvolvingSequence``.
        """
        idx = len(self.snapshot_keys)
        self.snapshot_keys.append(keys)
        if idx > 0:
            self.additions.append(added)
            self.deletions.append(deleted)
        return idx


class EdgeLog:
    """Append-only edge-event log with bounded-buffer backpressure.

    Events may arrive out of timestamp order as long as they are above the
    last cut's watermark; at or below it they are **late**, rejected and
    metered. ``max_pending_events`` bounds the pending buffer; ``policy``
    picks what happens at the bound: ``"block"`` raises
    :class:`BackpressureStall`, ``"drop"`` discards (lossy, metered),
    ``"spill"`` diverts to an unbounded spill buffer whose events rejoin at
    the next cut in (timestamp, arrival) order (lossless, deterministic).
    """

    def __init__(self, num_nodes: int, *,
                 max_pending_events: "int | None" = None,
                 policy: str = "block",
                 metrics: "IngestMetrics | None" = None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        if max_pending_events is not None and max_pending_events < 1:
            raise ValueError(f"max_pending_events must be >= 1, "
                             f"got {max_pending_events}")
        self.num_nodes = num_nodes
        self.max_pending_events = max_pending_events
        self.policy = policy
        self.metrics = metrics if metrics is not None else IngestMetrics()
        self._pending: "list[tuple[int, EdgeEvent]]" = []  # (arrival, event)
        self._spill: "list[tuple[int, EdgeEvent]]" = []
        self._arrivals = itertools.count()
        self._sealed_ts: "int | None" = None   # last cut watermark
        self._latest_ts = 0                    # default-ts tick

    def append(self, src: int, dst: int, w: "float | None" = None,
               op: str = "add", ts: "int | None" = None) -> "EdgeEvent | None":
        """Record one edge event; returns it, or ``None`` if rejected.

        ``ts=None`` stamps the latest timestamp seen so far (0 initially).
        Late events are rejected and metered; a full buffer applies the
        backpressure policy.
        """
        if op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {op!r}")
        if not (0 <= src < self.num_nodes and 0 <= dst < self.num_nodes):
            raise ValueError(f"edge ({src}, {dst}) out of range for "
                             f"{self.num_nodes} nodes")
        if ts is None:
            ts = self._latest_ts
        ts = int(ts)
        if self._sealed_ts is not None and ts <= self._sealed_ts:
            self.metrics.late_events += 1
            return None
        event = EdgeEvent(ts, int(src), int(dst), op,
                          None if w is None else float(w))
        if (self.max_pending_events is not None
                and len(self._pending) >= self.max_pending_events):
            if self.policy == "block":
                self.metrics.stalls += 1
                raise BackpressureStall(
                    f"EdgeLog pending buffer full "
                    f"({self.max_pending_events} events): cut the "
                    "watermark before appending more")
            if self.policy == "drop":
                self.metrics.dropped += 1
                return None
            self.metrics.spilled += 1
            self._spill.append((next(self._arrivals), event))
        else:
            self._pending.append((next(self._arrivals), event))
        self.metrics.events += 1
        self._latest_ts = max(self._latest_ts, ts)
        return event

    def extend(self, events) -> int:
        """Append an iterable of :class:`EdgeEvent`; returns the accepted
        count (backpressure applies per event; a stall propagates)."""
        accepted = 0
        for ev in events:
            if self.append(ev.src, ev.dst, w=ev.w, op=ev.op,
                           ts=ev.ts) is not None:
                accepted += 1
        return accepted

    def pending_events(self) -> int:
        """Events buffered (pending + spilled) and not yet cut."""
        return len(self._pending) + len(self._spill)

    def _take_upto(self, ts: int) -> "list[EdgeEvent]":
        """Remove and return every buffered event with ``event.ts <= ts``,
        sorted by (timestamp, arrival order), spill included."""
        taken, kept_p, kept_s = [], [], []
        for bucket, kept in ((self._pending, kept_p), (self._spill, kept_s)):
            for arrival, ev in bucket:
                (taken if ev.ts <= ts else kept).append((arrival, ev))
        self._pending, self._spill = kept_p, kept_s
        taken.sort(key=lambda item: (item[1].ts, item[0]))
        return [ev for _, ev in taken]

    def _seal(self, ts: int) -> None:
        """Mark ``ts`` consumed: later appends at or below it are late."""
        if self._sealed_ts is None or ts > self._sealed_ts:
            self._sealed_ts = ts


class Watermark:
    """Watermark-based snapshot cuts over one ``EdgeLog``/``SnapshotStore``.

    ``advance(ts)`` declares "every event at or below ``ts`` has arrived";
    ``cut()`` materializes those events as ONE new snapshot + Δ pair (the
    only ``SnapshotStore.ingest_cut`` caller), maintaining the running
    common graph online; :meth:`compact` drives retirement.
    """

    def __init__(self, log: EdgeLog, store: SnapshotStore):
        self.log = log
        self.store = store
        self.metrics = log.metrics
        self._ts: "int | None" = None
        self._common: "np.ndarray | None" = None
        self._common_lo = 0

    @property
    def ts(self) -> "int | None":
        """Current watermark timestamp (``None`` before any advance)."""
        return self._ts

    def advance(self, ts: int) -> "Watermark":
        """Move the watermark forward (monotone; regressions raise)."""
        ts = int(ts)
        if self._ts is not None and ts < self._ts:
            raise ValueError(f"watermark cannot regress: {ts} < {self._ts}")
        self._ts = ts
        return self

    def cut(self) -> "int | None":
        """Materialize one snapshot from all events at or below the
        watermark.

        Consumes the eligible events in (timestamp, arrival) order with
        last-op-wins per edge, filters no-ops (add of a present edge,
        delete of an absent one: ``redundant_events``) and installs the
        snapshot + canonical Δ pair with the running common graph. Returns
        the new index, or ``None`` when no eligible event arrived and a
        snapshot already exists. The consumed range is sealed.
        """
        if self._ts is None:
            raise ValueError("advance() the watermark before cutting")
        store, metrics = self.store, self.metrics
        events = self.log._take_upto(self._ts)
        num_before = store.seq.num_snapshots
        if not events and num_before > 0:
            self.log._seal(self._ts)
            return None
        if num_before:
            current = store.window_keys(num_before - 1, num_before - 1)
        else:
            current = np.empty(0, np.int64)

        last_op: "dict[int, str]" = {}
        for ev in events:
            key = int(edge_keys(np.int64(ev.src), np.int64(ev.dst),
                                store.num_nodes))
            last_op[key] = ev.op
        add_keys = np.sort(np.array(
            [k for k, op in last_op.items() if op == "add"], dtype=np.int64))
        del_keys = np.sort(np.array(
            [k for k, op in last_op.items() if op == "del"], dtype=np.int64))
        add_is_new = ~isin_sorted(add_keys, current)
        del_is_present = isin_sorted(del_keys, current)
        applied_adds = add_keys[add_is_new]
        applied_dels = del_keys[del_is_present]
        metrics.redundant_events += (len(events) - len(last_op)
                                     + int((~add_is_new).sum())
                                     + int((~del_is_present).sum()))
        metrics.applied_additions += int(applied_adds.shape[0])
        metrics.applied_deletions += int(applied_dels.shape[0])
        new_keys = merge_changes(current, applied_adds, applied_dels)

        if num_before == 0:
            # First cut: the snapshot IS the running common graph.
            self._common, self._common_lo = new_keys, store.first_live
            idx = store.ingest_cut(new_keys,
                                   np.empty(0, np.int64),
                                   np.empty(0, np.int64))
        else:
            if self._common is None or self._common_lo != store.first_live:
                # (Re)base after compaction moved the live window.
                self._common = store.window_keys(store.first_live,
                                                 num_before - 1)
                self._common_lo = store.first_live
            # Additions are disjoint from the previous snapshot (hence
            # from its intersection): only deletions shrink the common
            # graph.
            shrunk = np.setdiff1d(self._common, applied_dels,
                                  assume_unique=True)
            metrics.common_shrinkage += int(self._common.shape[0]
                                            - shrunk.shape[0])
            self._common = shrunk
            idx = store.ingest_cut(new_keys, applied_adds, applied_dels,
                                   common=shrunk,
                                   common_lo=self._common_lo)
        metrics.cuts += 1
        self.log._seal(self._ts)
        return idx

    def compact(self, before: "int | None" = None):
        """Retire snapshots via ``SnapshotStore.compact`` and meter it;
        when anything was retired the running common graph is rebased at
        the next cut. Returns the store's ``CompactionStats``."""
        stats = self.store.compact(before)
        self.metrics.compactions += 1
        self.metrics.retired_snapshots += stats.retired
        self.metrics.freed_edges += stats.freed_edges
        if stats.retired:
            self._common = None
        return stats


class LiveWindowFeed:
    """Emits slide windows the moment their newest snapshot is cut.

    Attach one feed to one ``WindowStream(feed=...)`` (or
    ``QueryService.register(..., feed=...)`` client) and ``poll()`` after
    cuts: each width-``width`` window ``(lo, lo + width - 1)`` is born when
    snapshot ``lo + width - 1`` exists. The feed registers a compaction
    floor under its name so the store never retires a snapshot an
    unconsumed (or future) window still needs. One feed serves one
    consumer.
    """

    def __init__(self, store: SnapshotStore, width: int, step: int = 1,
                 name: "str | None" = None):
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        if step < 1:
            raise ValueError(f"step must be >= 1, got {step}")
        self.store = store
        self.width = width
        self.step = step
        self.name = name if name is not None else f"feed-{next(_FEED_COUNTER)}"
        self.next_lo = store.first_live
        store.set_floor(self.name, self.next_lo)

    def poll(self) -> "list[tuple[int, int]]":
        """Windows born since the last poll (empty when none), in order."""
        born = []
        last = self.store.seq.num_snapshots - 1
        while self.next_lo + self.width - 1 <= last:
            born.append((self.next_lo, self.next_lo + self.width - 1))
            self.next_lo += self.step
        return born

    def advance_floor(self, lo: "int | None" = None) -> None:
        """Report consumer progress: ``lo`` is the first *unconsumed*
        window's low (``None`` = fully drained: the floor moves to the next
        unborn window's low)."""
        floor = self.next_lo if lo is None else min(int(lo), self.next_lo)
        self.store.set_floor(self.name, floor)

    def close(self) -> None:
        """Withdraw the feed's compaction floor (consumer finished)."""
        self.store.drop_floor(self.name)


def events_from_sequence(seq) -> "list[EdgeEvent]":
    """Flatten an evolving sequence into a replayable edge-event trace.

    Timestamp 0 carries every edge of snapshot 0 as an add; timestamp
    ``t + 1`` carries transition ``t``'s deletions then additions.
    Replaying it with one cut per distinct timestamp (:func:`replay_events`)
    reproduces ``seq`` exactly.
    """
    events: "list[EdgeEvent]" = []

    def emit(ts: int, keys: np.ndarray, op: str) -> None:
        src, dst = keys_to_edges(keys, seq.num_nodes)
        events.extend(EdgeEvent(ts, int(s), int(d), op)
                      for s, d in zip(src, dst))

    emit(0, seq.snapshot_keys[0], "add")
    for t in range(len(seq.additions)):
        emit(t + 1, seq.deletions[t], "del")
        emit(t + 1, seq.additions[t], "add")
    return events


def replay_events(log: EdgeLog, watermark: Watermark, events, *,
                  on_cut=None) -> "list[int]":
    """Drive a ts-sorted event trace through log → watermark → cuts.

    Appends each event and cuts once per distinct timestamp, calling
    ``on_cut(snapshot_index)`` after each materialized cut (where a live
    consumer drains its ``WindowStream`` or turns its ``QueryService``).
    Under ``"block"`` the buffer must hold one tick's events; ``"spill"``
    replays any trace losslessly; ``"drop"`` lossily. Returns the cut
    snapshot indices.
    """
    cuts: "list[int]" = []

    def cut_now(ts: int) -> None:
        idx = watermark.advance(ts).cut()
        if idx is not None:
            cuts.append(idx)
            if on_cut is not None:
                on_cut(idx)

    prev_ts: "int | None" = None
    for ev in events:
        if prev_ts is not None and ev.ts < prev_ts:
            raise ValueError(
                f"replay_events needs a ts-sorted trace: {ev.ts} after "
                f"{prev_ts} (sort the events, or feed the log directly)")
        if prev_ts is not None and ev.ts > prev_ts:
            cut_now(prev_ts)
        log.append(ev.src, ev.dst, w=ev.w, op=ev.op, ts=ev.ts)
        prev_ts = ev.ts
    if prev_ts is not None:
        cut_now(prev_ts)
    return cuts

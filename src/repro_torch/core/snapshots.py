"""Snapshot store: window intersections, Δ-batches, mutation-free views,
live growth and compaction (PyTorch port of ``repro.core.snapshots``).

This is the paper's graph representation: the CommonGraph of any window
plus immutable Δ-batches. For nested windows ``[i..j] ⊇ [a..b]``:
``T(i,j) ⊆ T(a,b)``, so descending the Triangular Grid only ever *adds*
edges, and ``|Δ(T(i,j) → T(a,b))| = |T(a,b)| − |T(i,j)|``. Snapshots are
the diagonal: ``S_i = T(i,i)``.

Set algebra runs host-side on sorted int64 key arrays (numpy, copied from
the reference). Device blocks are int32/float32 tensors on the store's
device.

Store contract (what every executor may assume):

* **Pure cache.** Every block is a pure function of ``(seq, tag)``:
  evicting a block and re-fetching it rebuilds a bit-identical tensor.
* **Bounded device memory (opt-in).** ``cache_bytes`` puts the block cache
  under an LRU byte budget charged in tensor bytes; :meth:`release` drops
  whole families.
* **Shape bucketing.** Blocks are padded to granule buckets (pow2 by
  default); stacked lane buffers bucket their lane axis
  (``delta_stack(num_lanes=)``, trailing lanes all-sentinel).
* **Anchor-state family ("AS" tags).** Converged ``QueryState`` s live in
  the same LRU beside edge blocks.
* **Pinning.** ``pin``/``unpin`` exempt a tag from LRU eviction and from
  ``release``; pinning never changes results.
* **Replicas.** ``replicas`` places cached blocks on the other devices of
  a ``data`` mesh: copies kept per (tag, device) outside the LRU's byte
  accounting, tag order and evictions, dropped when their tag leaves the
  cache.
* **Live stores.** Over a mutable sequence (``ingest.LiveSequence``)
  ``ingest_cut`` appends cut snapshots and ``compact`` retires snapshots
  no registered floor or pinned "AS" anchor still needs; ``first_live``
  is the oldest snapshot kept.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.graph.edgeset import (
    EdgeBlock,
    EdgeView,
    keys_to_edges,
    make_block,
    stack_delta_blocks,
)
from repro_torch.graph.generators import EvolvingSequence
from repro_torch.runtime import trace


def tightest_cover(candidates, window, size_fn):
    """Largest-|T| candidate window covering ``window`` (None if none).

    A state converged on ``(ci, cj)`` can warm-start ``window = (a, b)``
    iff ``ci <= a and b <= cj``; among covers the largest
    ``size_fn(ci, cj)`` minimizes the hop's Δ volume.
    """
    a, b = window
    best, best_size = None, -1
    for cand in candidates:
        ci, cj = cand
        if ci <= a and b <= cj:
            size = size_fn(ci, cj)
            if size > best_size:
                best, best_size = cand, size
    return best


def anchor_tag(qkey: tuple, window: "tuple[int, int]") -> tuple:
    """The canonical "AS"-family cache tag for an anchor state:
    ``("AS", qkey, (i, j))``."""
    return ("AS", qkey, tuple(window))


@dataclasses.dataclass(frozen=True)
class CompactionStats:
    """What one :meth:`SnapshotStore.compact` call retired: ``horizon`` is
    the first snapshot kept after clamping to every floor and pinned "AS"
    anchor, ``retired`` the snapshots freed by this call, ``freed_edges``
    the host-side key/Δ entries released."""

    horizon: int
    retired: int
    freed_edges: int


def _tag_min_index(tag: tuple) -> "int | None":
    """Smallest snapshot index a cached tag depends on (None = keep).

    ``("T", i, j)`` and ``("Ts", i, j, n, k)`` depend on ``i``; ``("D",
    parent, child)`` and ``("DS", lanes, *hops)`` on the smallest window
    low of their hops; ``("A", t)`` on ``t``; ``("AS", qkey, (i, j))`` on
    ``i``. Unknown families are kept.
    """
    fam = tag[0]
    if fam in ("T", "Ts"):
        return int(tag[1])
    if fam == "D":
        return min(int(tag[1][0]), int(tag[2][0]))
    if fam == "DS":
        return min(int(w[0]) for hop in tag[2:] for w in hop)
    if fam == "A":
        return int(tag[1])
    if fam == "AS":
        return int(tag[2][0])
    return None


def _block_nbytes(blk) -> int:
    # Cached entries that know their own footprint (engine QueryStates via
    # the ``nbytes`` hook) report it; raw EdgeBlocks are summed directly.
    n = getattr(blk, "nbytes", None)
    if n is not None:
        return int(n)
    return sum(a.numel() * a.element_size() for a in blk)


class SnapshotStore:
    """Caches window common-graphs T(i,j) (key arrays) and device blocks.

    Blocks are built on ``device`` (default ``"cuda"``). ``cache_bytes``
    (default ``None`` = unbounded) bounds the block cache by LRU; the block
    just built is always kept. ``release`` drops whole block families.
    Both are safe: re-fetching rebuilds bit-identical blocks from the
    retained host-side key arrays.
    """

    def __init__(self, seq: EvolvingSequence, granule: int = 4096,
                 pad_pow2: bool = True, cache_bytes: int | None = None,
                 device: str | torch.device = "cuda"):
        self.seq = seq
        self.num_nodes = seq.num_nodes
        self.granule = granule
        self.pad_pow2 = pad_pow2
        self.cache_bytes = cache_bytes
        self.device = torch.device(device)
        self._t: dict[tuple[int, int], np.ndarray] = {
            (i, i): seq.snapshot_keys[i] for i in range(seq.num_snapshots)
        }
        self._blocks: OrderedDict[tuple, EdgeBlock] = OrderedDict()
        # tag -> {device: the cached block's copy there} (see replicas())
        self._replicas: dict[tuple, dict[torch.device, EdgeBlock]] = {}
        self._cached_nbytes = 0
        self._pins: dict[tuple, int] = {}   # tag -> refcount (see pin())
        self.evictions = 0  # lifetime count, for tests/benchmarks
        self.first_live = 0  # oldest non-retired snapshot (see compact())
        self._floors: dict[str, int] = {}   # name -> oldest index needed

    # -- block cache (LRU by bytes + explicit release) -------------------------

    @property
    def cached_nbytes(self) -> int:
        """Current device-block cache footprint (padded tensor bytes)."""
        return self._cached_nbytes

    def _cache_get(self, tag: tuple) -> EdgeBlock | None:
        blk = self._blocks.get(tag)
        if blk is not None:
            self._blocks.move_to_end(tag)
        return blk

    def _cache_put(self, tag: tuple, blk: EdgeBlock) -> EdgeBlock:
        # Overwriting an existing tag must displace the old entry's bytes.
        old = self._blocks.pop(tag, None)
        if old is not None:
            self._cached_nbytes -= _block_nbytes(old)
            self._replicas.pop(tag, None)
        self._blocks[tag] = blk
        self._cached_nbytes += _block_nbytes(blk)
        if self.cache_bytes is not None and self._cached_nbytes > self.cache_bytes:
            # LRU order, skipping pinned tags and the entry just stored.
            for old_tag in list(self._blocks):
                if self._cached_nbytes <= self.cache_bytes \
                        or len(self._blocks) <= 1:
                    break
                if old_tag == tag or self._pins.get(old_tag):
                    continue
                self._cached_nbytes -= _block_nbytes(self._blocks.pop(old_tag))
                self._replicas.pop(old_tag, None)
                self.evictions += 1
        return blk

    def pin(self, tag: tuple) -> None:
        """Exempt a cached entry from LRU eviction (refcounted; legal before
        the entry exists). Pinned entries still count toward
        ``cache_bytes``; :meth:`release` skips them."""
        self._pins[tag] = self._pins.get(tag, 0) + 1

    def unpin(self, tag: tuple) -> None:
        """Drop one pin refcount; at zero the entry rejoins the LRU."""
        n = self._pins.get(tag, 0) - 1
        if n < 0:
            raise ValueError(f"unpin without matching pin for tag {tag!r}")
        if n == 0:
            del self._pins[tag]
        else:
            self._pins[tag] = n

    def pinned_tags(self) -> "set[tuple]":
        """Tags currently exempt from eviction (for tests/diagnostics)."""
        return set(self._pins)

    def pin_count(self, tag: tuple) -> int:
        """Current pin refcount of ``tag`` (0 when unpinned)."""
        return self._pins.get(tag, 0)

    def release(self, kinds: "tuple[str, ...] | None" = None) -> int:
        """Drop cached device blocks; returns the number of bytes released.

        ``kinds`` filters by tag family (e.g. ``("DS",)`` or ``("AS",)``);
        ``None`` drops everything except pinned entries. Host-side key
        arrays are never dropped, so later fetches rebuild bit-identical
        blocks.
        """
        if isinstance(kinds, str):  # release("DS") must not match family "D"
            kinds = (kinds,)
        drop = [t for t in self._blocks
                if (kinds is None or t[0] in kinds) and not self._pins.get(t)]
        freed = 0
        for t in drop:
            freed += _block_nbytes(self._blocks.pop(t))
            self._replicas.pop(t, None)
        self._cached_nbytes -= freed
        return freed

    def replicas(self, blocks, device: torch.device) -> "tuple[EdgeBlock, ...]":
        """``blocks`` (a view's blocks) on ``device``: the blocks themselves
        where they already lie there, else copies. A cached block's copy is
        kept per (tag, device) until its tag leaves the cache (eviction,
        overwrite, :meth:`release`, :meth:`compact`); it is not charged to
        ``cached_nbytes`` and does not touch the LRU's order, so the
        store's eviction behaviour stays that of the unsharded run."""
        device = torch.device(device)
        out = []
        for blk in blocks:
            if blk.src.device == device:
                out.append(blk)
                continue
            tag = next((t for t, b in self._blocks.items() if b is blk), None)
            copies = ({} if tag is None
                      else self._replicas.setdefault(tag, {}))
            if device not in copies:
                copies[device] = EdgeBlock(*(a.to(device) for a in blk))
            out.append(copies[device])
        return tuple(out)

    # -- anchor-state cache ("AS" family) ----------------------------------------

    def anchor_state_get(self, qkey: tuple, window: "tuple[int, int]"):
        """Cached converged QueryState for exactly this (qkey, window)."""
        return self._cache_get(anchor_tag(qkey, window))

    def anchor_state_put(self, qkey: tuple, window: "tuple[int, int]", state):
        """Cache a converged anchor state (LRU-participating, "AS" family)."""
        return self._cache_put(anchor_tag(qkey, window), state)

    def anchor_state_cover(self, qkey: tuple, window: "tuple[int, int]"):
        """Tightest cached anchor state whose window COVERS ``window``.

        Returns ``(cover_window, state)`` or ``None``; the exact window
        itself is excluded (use :meth:`anchor_state_get` for hits).
        """
        window = tuple(window)
        best = tightest_cover(
            [tag[2] for tag in self._blocks
             if tag[0] == "AS" and tag[1] == qkey and tag[2] != window],
            window, self.window_size)
        if best is None:
            return None
        return best, self._cache_get(anchor_tag(qkey, best))  # touches LRU

    # -- window intersections -------------------------------------------------

    def window_keys(self, i: int, j: int) -> np.ndarray:
        """Sorted keys of T(i,j) = ⋂_{k∈[i..j]} S_k (cached, built
        left-to-right from the widest cached prefix (i, k))."""
        if (i, j) in self._t:
            return self._t[(i, j)]
        if j < i:
            raise ValueError(f"window ({i}, {j}) is empty: need i <= j")
        if i < self.first_live:
            raise ValueError(
                f"window ({i}, {j}) reaches below first_live="
                f"{self.first_live}: snapshot {i} was retired by compact()")
        with trace.span("store.window_keys"):
            k = j
            while (i, k) not in self._t:
                k -= 1
            cur = self._t[(i, k)]
            for m in range(k + 1, j + 1):
                cur = np.intersect1d(cur, self.seq.snapshot_keys[m],
                                     assume_unique=True)
                self._t[(i, m)] = cur
        return cur

    def window_size(self, i: int, j: int) -> int:
        """|T(i, j)| — the edge count every Δ-volume cost model uses."""
        return int(self.window_keys(i, j).shape[0])

    def delta_keys(self, parent: tuple[int, int], child: tuple[int, int]) -> np.ndarray:
        """Edges added when descending T(parent) → T(child); child ⊆ parent window."""
        pi, pj = parent
        ci, cj = child
        if not (pi <= ci and cj <= pj):
            raise ValueError(f"child window {child} not nested in parent {parent}")
        with trace.span("store.delta_keys"):
            return np.setdiff1d(self.window_keys(ci, cj),
                                self.window_keys(pi, pj), assume_unique=True)

    # -- device blocks ---------------------------------------------------------

    def block_for_keys(self, keys: np.ndarray, tag: tuple) -> EdgeBlock:
        """Immutable padded device block for a key set (cached by tag)."""
        blk = self._cache_get(tag)
        if blk is not None:
            return blk
        with trace.span("store.block"):
            src, dst = keys_to_edges(keys, self.num_nodes)
            w = self.seq.weights_for(keys)
            blk = make_block(src, dst, w, self.num_nodes,
                             granule=self.granule, pad_pow2=self.pad_pow2,
                             device=self.device)
            return self._cache_put(tag, blk)

    def window_block(self, i: int, j: int) -> EdgeBlock:
        """T(i, j) as a single cached device block (tag family "T")."""
        return self.block_for_keys(self.window_keys(i, j), ("T", i, j))

    def window_view_split(self, i: int, j: int, n_blocks: int) -> EdgeView:
        """Window view split into src-contiguous sub-blocks (keys are
        src-major, so each sub-block covers a narrow source range)."""
        keys = self.window_keys(i, j)
        chunks = np.array_split(keys, n_blocks)
        blocks = tuple(
            self.block_for_keys(c, ("Ts", i, j, n_blocks, k))
            for k, c in enumerate(chunks) if c.size)
        return EdgeView(blocks, self.num_nodes)

    def delta_block(self, parent: tuple[int, int], child: tuple[int, int]) -> EdgeBlock:
        """The addition batch of one nested-window hop (tag family "D").

        The tag needs no keys, so a cached hop is returned before
        :meth:`delta_keys` would run its set difference.
        """
        tag = ("D", parent, child)
        blk = self._cache_get(tag)
        if blk is not None:
            return blk
        return self.block_for_keys(self.delta_keys(parent, child), tag)

    def delta_stack(
        self, hops: "list[tuple[tuple[int, int], tuple[int, int]]]",
        num_lanes: int | None = None,
    ) -> EdgeBlock:
        """Stacked Δ-batches for several parent→child hops (one lane per hop).

        The lanes of one plan level are independent sibling hops; stacking
        them (shape-bucketed, see ``stack_delta_blocks``) turns the level
        into one batched launch. ``num_lanes`` buckets the lane axis
        (trailing all-sentinel lanes) and is part of the cache tag.
        """
        tag = ("DS", num_lanes or len(hops)) + tuple(hops)
        blk = self._cache_get(tag)
        if blk is not None:
            return blk
        with trace.span("store.block"):
            lanes = []
            for parent, child in hops:
                keys = self.delta_keys(parent, child)
                s, d = keys_to_edges(keys, self.num_nodes)
                lanes.append((s, d, self.seq.weights_for(keys)))
            blk = stack_delta_blocks(lanes, self.num_nodes,
                                     granule=self.granule,
                                     pad_pow2=self.pad_pow2,
                                     num_lanes=num_lanes, device=self.device)
            return self._cache_put(tag, blk)

    def snapshot_view(self, i: int) -> EdgeView:
        """Standalone single-block view of S_i (used by from-scratch baselines)."""
        return EdgeView((self.window_block(i, i),), self.num_nodes)

    def common_graph_view(self, i: int | None = None,
                          j: int | None = None) -> EdgeView:
        """Single-block view of T(i, j); defaults to the global common graph
        over the live range (``first_live`` .. last snapshot)."""
        if i is None:
            i = self.first_live
        if j is None:
            j = self.seq.num_snapshots - 1
        return EdgeView((self.window_block(i, j),), self.num_nodes)

    # -- change batches (for the KickStarter streaming baseline) ---------------

    def addition_block(self, t: int) -> EdgeBlock:
        """Edges added at transition t → t+1."""
        return self.block_for_keys(self.seq.additions[t], ("A", t))

    def deletion_keys(self, t: int) -> np.ndarray:
        """Keys deleted at transition t → t+1 (KickStarter baseline input)."""
        return self.seq.deletions[t]

    # -- live ingestion (core/ingest.py) ---------------------------------------
    #
    # The one write path that grows the store after construction: a live
    # store wraps a mutable sequence (ingest.LiveSequence); `ingest_cut`
    # appends one snapshot + canonical Δ pair per watermark cut, and
    # `compact` retires snapshots no registered floor or pinned "AS" anchor
    # still needs.

    def ingest_cut(self, keys: np.ndarray, added: np.ndarray,
                   deleted: np.ndarray, common: "np.ndarray | None" = None,
                   common_lo: "int | None" = None) -> int:
        """Install one cut snapshot + Δ pair; returns its index.

        Called from ``ingest.Watermark.cut``: appends to the live sequence,
        registers the new diagonal ``(idx, idx)`` in the window cache and,
        when given the watermark's running common graph ``common`` over
        ``[common_lo .. idx]``, installs it too. A frozen
        ``EvolvingSequence`` store raises ``TypeError``.
        """
        append = getattr(self.seq, "append", None)
        if append is None:
            raise TypeError(
                "ingest_cut needs a mutable live sequence "
                "(ingest.LiveSequence); EvolvingSequence stores are "
                "precomputed inputs")
        idx = append(keys, added, deleted)
        self._t[(idx, idx)] = keys
        if common is not None and common_lo is not None and common_lo != idx:
            self._t[(common_lo, idx)] = common
        return idx

    def set_floor(self, name: str, index: int) -> None:
        """Register or move a named compaction floor: the consumer ``name``
        needs no snapshot older than ``index``. ``compact`` clamps its
        horizon to the smallest floor."""
        self._floors[name] = int(index)

    def drop_floor(self, name: str) -> None:
        """Withdraw a named floor (missing names are a no-op)."""
        self._floors.pop(name, None)

    @property
    def stored_edges(self) -> int:
        """Host-side edge entries currently stored (snapshot keys + Δ
        pairs); retired entries are ``None`` and count zero."""
        seq = self.seq
        arrays = list(seq.snapshot_keys) + list(seq.additions) \
            + list(seq.deletions)
        return sum(int(a.shape[0]) for a in arrays if a is not None)

    def compact(self, before: "int | None" = None) -> CompactionStats:
        """Retire snapshots older than every consumer still needs.

        The horizon starts at ``before`` (default: the latest snapshot) and
        clamps down to every floor (:meth:`set_floor`) and every pinned
        "AS" anchor's window low. Snapshots below it are freed (host arrays
        become ``None``, indices never shift), window-cache entries and
        device blocks that depend on them are dropped (pinned tags kept,
        bytes subtracted from ``cached_nbytes`` as the LRU would, not
        counted as evictions), and ``first_live`` advances. Requires a
        mutable live sequence, like :meth:`ingest_cut`.
        """
        seq = self.seq
        if not isinstance(seq.snapshot_keys, list):
            raise TypeError(
                "compact needs a mutable live sequence "
                "(ingest.LiveSequence); EvolvingSequence stores are "
                "precomputed inputs")
        horizon = seq.num_snapshots - 1 if before is None else int(before)
        for floor in self._floors.values():
            horizon = min(horizon, floor)
        for tag in self._pins:
            if tag[0] == "AS":
                horizon = min(horizon, int(tag[2][0]))
        horizon = max(horizon, self.first_live)
        freed = 0
        for i in range(self.first_live, horizon):
            freed += int(seq.snapshot_keys[i].shape[0])
            seq.snapshot_keys[i] = None
            if seq.additions[i] is not None:
                freed += int(seq.additions[i].shape[0])
                freed += int(seq.deletions[i].shape[0])
                seq.additions[i] = None
                seq.deletions[i] = None
        retired = horizon - self.first_live
        if retired:
            for w in [w for w in self._t if w[0] < horizon]:
                del self._t[w]
            for tag in list(self._blocks):
                low = _tag_min_index(tag)
                if low is not None and low < horizon \
                        and not self._pins.get(tag):
                    self._cached_nbytes -= _block_nbytes(
                        self._blocks.pop(tag))
                    self._replicas.pop(tag, None)
            self.first_live = horizon
        return CompactionStats(horizon=horizon, retired=retired,
                               freed_edges=freed)

    # -- sliding windows (core/window.py) --------------------------------------
    #
    # Sliding [i..j] → [i+1..j+1] is NOT deletion-free from the old apex:
    # T(i,j) ⊄ T(i+1,j+1) in general. The sound anchor is any SUPER-window
    # apex, from which every window apex is reachable by additions only.
    # ``slide_block`` is delta_block with the anchor made explicit, so all
    # nesting validation and caching carry over. The default anchor is the
    # live range's window ``(first_live, last)``, the widest one a
    # compacted store can still intersect.

    def slide_block(self, new_window: tuple[int, int],
                    anchor: tuple[int, int] | None = None) -> EdgeBlock:
        """Addition batch hopping the anchor apex state to ``new_window``'s
        apex (``anchor`` defaults to the live range's window)."""
        if anchor is None:
            anchor = (self.first_live, self.seq.num_snapshots - 1)
        return self.delta_block(anchor, new_window)

    def slide_stack(self, windows: "list[tuple[int, int]]",
                    anchor: tuple[int, int] | None = None,
                    num_lanes: int | None = None) -> EdgeBlock:
        """Stacked slide deltas: one lane per window, all hopping from
        ``anchor`` (default: the live range's window); ``num_lanes``
        buckets the lane axis exactly as in :meth:`delta_stack`."""
        if anchor is None:
            anchor = (self.first_live, self.seq.num_snapshots - 1)
        return self.delta_stack([(anchor, w) for w in windows],
                                num_lanes=num_lanes)

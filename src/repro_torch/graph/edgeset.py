"""Immutable, mutation-free edge containers (PyTorch port of
``repro.graph.edgeset``).

A graph (or any Triangular-Grid node) is an :class:`EdgeView`: an ordered
tuple of immutable :class:`EdgeBlock` s — the CommonGraph block plus
whichever Δ-batches the view needs. Blocks are shared between snapshots;
realizing a snapshot costs zero copies.

Padding convention (unchanged from the reference): blocks are padded to a
granule bucket. A padding edge has ``dst == num_nodes`` (it lands in a
sentinel segment that every reduction drops) and ``src == PAD_SRC == 0``
(gathers stay in-bounds). Blocks are int32/float32 tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

PAD_SRC = 0
DEFAULT_GRANULE = 4096


class EdgeBlock(NamedTuple):
    """One immutable, padded block of edges: three tensors on one device,
    ``[n_padded]`` or, stacked, ``[lanes, n_padded]``."""

    src: torch.Tensor  # int32
    dst: torch.Tensor  # int32 (== num_nodes for padding)
    w: torch.Tensor    # float32

    @property
    def n_padded(self) -> int:
        return int(self.src.shape[-1])


def _pad_to(n: int, granule: int, pow2: bool = False) -> int:
    if pow2:
        # Power-of-two bucket padding bounds the number of distinct block
        # shapes at ≤2× memory overhead.
        m = granule
        while m < n:
            m *= 2
        return m
    if n == 0:
        return granule
    return ((n + granule - 1) // granule) * granule


def lane_bucket(num_lanes: int, data_extent: int = 1) -> int:
    """Lane-axis bucket: pow2 lanes-per-device times ``data_extent``.

    The batched executors pad their lane (snapshot) axis to this count, so
    launch shapes depend only on ``(lane bucket, width bucket)``. Padding
    is < 2x ``num_lanes`` whenever the level has at least one lane per
    device; below that the bucket is exactly ``data_extent``.
    """
    if num_lanes < 1:
        raise ValueError(f"need at least one lane, got {num_lanes}")
    if data_extent < 1:
        raise ValueError(f"data_extent must be >= 1, got {data_extent}")
    per_device = -(-num_lanes // data_extent)
    b = 1
    while b < per_device:
        b *= 2
    return b * data_extent


def pad_edges(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray | None,
    num_nodes: int,
    granule: int = DEFAULT_GRANULE,
    pad_pow2: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
    """Pad host edge arrays to the granule bucket (sentinel dst, PAD_SRC src).

    The single place the padding convention lives: block construction and
    the KickStarter deletion batches both route through here.
    """
    n = src.shape[0]
    pad = _pad_to(n, granule, pow2=pad_pow2) - n
    if pad:
        src = np.concatenate([src, np.full(pad, PAD_SRC, np.int32)])
        dst = np.concatenate([dst, np.full(pad, num_nodes, np.int32)])
        if w is not None:
            w = np.concatenate([w, np.zeros(pad, np.float32)])
    return src, dst, w


def _host_block(src, dst, w, num_nodes, granule, sort_by_dst, pad_pow2):
    """Padded (optionally dst-sorted) host arrays of one block."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if w is None:
        w = np.ones(src.shape[0], dtype=np.float32)
    w = np.asarray(w, dtype=np.float32)
    if not (src.shape == dst.shape == w.shape):
        raise ValueError(f"edge array shape mismatch: {src.shape}, {dst.shape}, {w.shape}")
    if sort_by_dst and src.shape[0] > 0:
        order = stable_order(dst)
        src, dst, w = src[order], dst[order], w[order]
    return pad_edges(src, dst, w, num_nodes, granule=granule,
                     pad_pow2=pad_pow2)


def _to_device(src, dst, w, device) -> EdgeBlock:
    return EdgeBlock(torch.from_numpy(np.ascontiguousarray(src)).to(device),
                     torch.from_numpy(np.ascontiguousarray(dst)).to(device),
                     torch.from_numpy(np.ascontiguousarray(w)).to(device))


def make_block(
    src: np.ndarray,
    dst: np.ndarray,
    w: np.ndarray | None,
    num_nodes: int,
    granule: int = DEFAULT_GRANULE,
    sort_by_dst: bool = True,
    pad_pow2: bool = False,
    device: str | torch.device = "cuda",
) -> EdgeBlock:
    """Build a padded (optionally stably dst-sorted) EdgeBlock on ``device``
    from host arrays."""
    return _to_device(*_host_block(src, dst, w, num_nodes, granule,
                                   sort_by_dst, pad_pow2), device)


@dataclasses.dataclass(frozen=True)
class EdgeView:
    """A logical graph = ordered tuple of shared immutable blocks."""

    blocks: tuple[EdgeBlock, ...]
    num_nodes: int

    @property
    def n_padded(self) -> int:
        return sum(b.n_padded for b in self.blocks)

    @property
    def device(self) -> torch.device:
        """The device every block lives on."""
        return self.blocks[0].src.device

    def arrays(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Concatenated (src, dst, w)."""
        if len(self.blocks) == 1:
            b = self.blocks[0]
            return b.src, b.dst, b.w
        src = torch.cat([b.src for b in self.blocks])
        dst = torch.cat([b.dst for b in self.blocks])
        w = torch.cat([b.w for b in self.blocks])
        return src, dst, w

    def extended(self, *extra: EdgeBlock) -> "EdgeView":
        """A new view sharing this view's blocks plus ``extra`` (no copies)."""
        return EdgeView(self.blocks + tuple(extra), self.num_nodes)


def stack_delta_blocks(
    edge_lists: Sequence[tuple[np.ndarray, np.ndarray, np.ndarray | None]],
    num_nodes: int,
    granule: int = DEFAULT_GRANULE,
    pad_pow2: bool = True,
    sort_by_dst: bool = True,
    num_lanes: int | None = None,
    device: str | torch.device = "cuda",
) -> EdgeBlock:
    """Stack ragged per-lane edge lists into one EdgeBlock with a leading
    lane (snapshot) axis.

    Every lane is padded to ONE shared width — the granule bucket of the
    largest lane (power-of-two bucketed by default). ``num_lanes`` (default
    ``len(edge_lists)``) pads the lane axis too: trailing masked lanes are
    all-sentinel (every edge is a padding edge), so they relax nothing,
    seed no frontier and add no ``edge_work``; the matching validity mask
    is ``lane index < len(edge_lists)`` (``engine.batched_incremental``'s
    ``lane_valid``).
    """
    if not edge_lists:
        raise ValueError("stack_delta_blocks needs at least one lane")
    if num_lanes is not None and num_lanes < len(edge_lists):
        raise ValueError(f"num_lanes={num_lanes} < {len(edge_lists)} lanes")
    width = _pad_to(max(np.asarray(s).shape[0] for s, _, _ in edge_lists),
                    granule, pow2=pad_pow2)
    # granule=width + pad_pow2=False pads each lane to exactly `width`.
    lanes = [_host_block(s, d, w, num_nodes, width, sort_by_dst, False)
             for s, d, w in edge_lists]
    if num_lanes is not None and num_lanes > len(lanes):
        empty = np.empty(0, np.int32)
        masked = _host_block(empty, empty, None, num_nodes, width,
                             sort_by_dst, False)
        lanes.extend([masked] * (num_lanes - len(lanes)))
    return _to_device(np.stack([b[0] for b in lanes]),
                      np.stack([b[1] for b in lanes]),
                      np.stack([b[2] for b in lanes]), device)


def concat_views(a: EdgeView, b: EdgeView) -> EdgeView:
    """A view over both views' blocks (same vertex set)."""
    if a.num_nodes != b.num_nodes:
        raise ValueError("views over different node sets")
    return EdgeView(a.blocks + b.blocks, a.num_nodes)


# ---------------------------------------------------------------------------
# Host-side edge-set algebra (int64 keys), as in the reference. Used by core/
# to compute the CommonGraph intersection and Δ-batches.
#
# The reference's np.unique / np.isin / np.union1d / stable np.argsort calls
# are replaced by plain sorts and binary searches that return the same
# arrays: under numpy 2.3, whose np.unique hashes, the full-size evolving
# sequence (2^24 edges, 8 snapshots) took 450 s on the host of the H100
# machine (chip_smoke.py's main-path phase).
# ---------------------------------------------------------------------------

def unique_keys(keys: np.ndarray) -> np.ndarray:
    """``np.unique`` of a 1-D integer array (sorted distinct values), by
    one sort."""
    s = np.sort(keys)
    if s.size > 1:
        s = s[np.concatenate(([True], s[1:] != s[:-1]))]
    return s


def isin_sorted(keys: np.ndarray, table: np.ndarray) -> np.ndarray:
    """``np.isin(keys, table)`` for a sorted ``table``, by binary search."""
    if table.size == 0:
        return np.zeros(keys.shape, dtype=bool)
    idx = np.searchsorted(table, keys)
    idx[idx == table.size] = 0
    return table[idx] == keys


def stable_order(dst: np.ndarray) -> np.ndarray:
    """``np.argsort(dst, kind="stable")`` for non-negative integers: one
    plain sort of ``(dst << b) | index`` keys gives the same permutation,
    since equal ``dst`` keep their index order."""
    n = dst.shape[0]
    shift = max(1, n.bit_length())
    if n == 0 or int(dst.min()) < 0 \
            or int(dst.max()).bit_length() + shift > 62:
        return np.argsort(dst, kind="stable")
    comp = (dst.astype(np.int64) << shift) | np.arange(n, dtype=np.int64)
    comp.sort()
    return comp & ((1 << shift) - 1)


def edge_keys(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Injective int64 key for (src, dst) pairs."""
    return src.astype(np.int64) * np.int64(num_nodes) + dst.astype(np.int64)


def keys_to_edges(keys: np.ndarray, num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`edge_keys`: int32 (src, dst) arrays."""
    src = (keys // num_nodes).astype(np.int32)
    dst = (keys % num_nodes).astype(np.int32)
    return src, dst


def merge_changes(keys: np.ndarray, add_keys: np.ndarray,
                  del_keys: np.ndarray) -> np.ndarray:
    """Apply one change batch to a sorted key set: ``(keys ∖ del) ∪ add``.

    All three inputs must be sorted unique key arrays with ``del_keys ⊆
    keys`` and ``add_keys ∩ keys = ∅`` already enforced by the caller.
    """
    out = keys[~isin_sorted(keys, del_keys)]
    return unique_keys(np.concatenate([out, add_keys]))

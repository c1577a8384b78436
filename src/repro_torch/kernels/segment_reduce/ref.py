"""Plain PyTorch version of the segment_reduce kernel, and its layout.

    out[v, :] = reduce_{e : seg[e] == v} data[e, :]      reduce in {sum, min, max}

Ids outside ``[0, num_segments)`` are dropped, as ``jax.ops.segment_*``
drops them (the sentinel ``num_segments`` of padded edges among them). An
empty segment keeps the identity: +0.0 for sum, +inf for min, -inf for max.

The layout (``segment_layout``) is a stable sort of the ids, computed once
per index array and shared by the kernel, this plain version and the
gradients. The plain version reduces in the kernel's order without atomics:
each edge's rank within its segment comes from the stable sort, and a loop
over ranks ``r`` does ``acc[s] = op(acc[s], data[e])`` for the r-th edge of
every segment with more than r edges. Every (segment, column) is therefore
reduced in edge order from the identity, on any device, so sums equal a
sequential scatter-add (``jax.ops.segment_sum`` on the CPU) bit for bit.
min/max order -0.0 below +0.0 and propagate NaN, as XLA's min/max do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

IDENTITY = {"sum": 0.0, "min": math.inf, "max": -math.inf}


class SegmentLayout(NamedTuple):
    """Where each segment's edges are, in edge order.

    seg: int32 [E], the ids with those outside ``[0, num_segments)`` set to
    ``num_segments``; perm: int32 [E], a stable sort of ``seg`` (dropped
    edges last); offsets: int32 [num_segments + 1], segment s's edges are
    ``perm[offsets[s]:offsets[s + 1]]``.
    """
    seg: torch.Tensor
    perm: torch.Tensor
    offsets: torch.Tensor
    num_segments: int


def segment_layout(seg: torch.Tensor, num_segments: int) -> SegmentLayout:
    """The :class:`SegmentLayout` of int32 ids ``seg`` [E], on their device."""
    if seg.dim() != 1 or seg.dtype != torch.int32:
        raise TypeError(f"seg must be an int32 vector, got {seg.dtype} "
                        f"{tuple(seg.shape)}")
    if num_segments < 0 or seg.shape[0] >= 2**31:
        raise ValueError(f"need 0 <= num_segments and fewer than 2^31 ids, "
                         f"got {num_segments} segments, {seg.shape[0]} ids")
    inside = (seg >= 0) & (seg < num_segments)
    seg_c = torch.where(inside, seg, torch.full_like(seg, num_segments))
    sorted_seg, perm = torch.sort(seg_c, stable=True)
    bounds = torch.arange(num_segments + 1, dtype=torch.int32,
                          device=seg.device)
    offsets = torch.searchsorted(sorted_seg, bounds, out_int32=True)
    return SegmentLayout(seg_c, perm.to(torch.int32), offsets, num_segments)


def _combine(reduce: str, acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if reduce == "sum":
        return acc + x
    neg = torch.signbit(x)
    if reduce == "min":
        take = (x < acc) | ((x == acc) & neg)
    else:
        take = (x > acc) | ((x == acc) & ~neg)
    return torch.where(take | torch.isnan(x), x, acc)


def segment_reduce_ref(data, seg, *, num_segments: int, reduce: str = "sum",
                       layout: SegmentLayout | None = None) -> torch.Tensor:
    """data [E] or [E, D] float32; seg [E] int32. Returns [num_segments]
    or [num_segments, D] float32."""
    if reduce not in IDENTITY:
        raise ValueError(f"reduce must be one of {sorted(IDENTITY)}, got "
                         f"{reduce!r}")
    if layout is None:
        layout = segment_layout(seg, num_segments)
    rows = data if data.dim() == 2 else data[:, None]
    n = num_segments
    counts = (layout.offsets[1:] - layout.offsets[:-1]).long()
    # segments by count, largest first: the segments with more than r
    # edges are a prefix of this order, active[r] long
    order = torch.argsort(counts, descending=True, stable=True)
    starts = layout.offsets[:-1].long()[order]
    sorted_counts = counts[order].cpu()
    max_count = int(sorted_counts[0]) if n else 0
    active = n - torch.cumsum(
        torch.bincount(sorted_counts, minlength=max_count + 1), 0)
    acc = torch.full((n, rows.shape[1]), IDENTITY[reduce],
                     dtype=torch.float32, device=rows.device)
    perm = layout.perm.long()
    for r in range(max_count):
        k = int(active[r])
        edges = perm[starts[:k] + r]
        acc[:k] = _combine(reduce, acc[:k], rows.index_select(0, edges))
    out = torch.empty_like(acc).index_copy_(0, order, acc)
    return out.reshape((n,) + tuple(data.shape[1:]))

"""Plain PyTorch version of the embedding_bag kernel.

    out[b, :] = sum_{i : bags[i] == b} weights[i] * table[ids[i], :]

Bags outside ``[0, n_bags)`` are dropped (the reference's padding sentinel
``bag == n_bags`` among them) and their rows are never used; an empty bag
is +0.0. Each lookup's product ``w * row`` is rounded, then added to its
bag in lookup order from +0.0 (``segment_reduce_ref`` over the bag layout),
the kernel's order. So it equals the reference's take -> multiply ->
``segment_sum`` (``repro.models.embedding.embedding_bag``, a sequential
scatter-add on the CPU) bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.segment_reduce.ref import (
    SegmentLayout,
    segment_layout,
    segment_reduce_ref,
)


def embedding_bag_ref(table, ids, bags, weights, *, n_bags: int,
                      layout: SegmentLayout | None = None) -> torch.Tensor:
    """table [V, D] float32; ids, bags [L] int32; weights [L] float32.
    Returns [n_bags, D] float32."""
    if layout is None:
        layout = segment_layout(bags, n_bags)
    kept = layout.seg < n_bags
    rows = table.index_select(0, torch.where(kept, ids, torch.zeros_like(ids)))
    return segment_reduce_ref(rows * weights[:, None], layout.seg,
                              num_segments=n_bags, layout=layout)

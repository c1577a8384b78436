"""Embedding lookups and bags, the recsys substrate.

Counterpart of ``repro.models.embedding``. ``embedding_lookup`` is a row
gather whose backward (when the table needs a gradient) is
``segment_reduce``'s deterministic sum by id (``gather_rows``);
``embedding_bag``'s sums run in the ``embedding_bag`` kernel on CUDA (its
plain version on the CPU) and its max in ``segment_reduce``'s. Padded
lookups use ``bag_ids == n_bags`` and are dropped.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import embedding_bag as bag_sum
from repro_torch.kernels.segment_reduce import (
    SegmentLayout,
    gather_rows,
    segment_layout,
    segment_reduce,
)


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: int32 ids of any shape -> [..., D]. When the table
    requires a gradient, the ids' layout is computed once here and the
    backward is ``gather_rows``' deterministic sum by id."""
    flat = ids.reshape(-1)
    if table.requires_grad:
        rows = gather_rows(table, flat, segment_layout(flat, table.shape[0]))
    else:
        rows = table.index_select(0, flat)
    return rows.reshape(tuple(ids.shape) + (table.shape[1],))


def embedding_bag(
    table: torch.Tensor,        # [V, D] float32
    ids: torch.Tensor,          # [n_lookups] int32
    bag_ids: torch.Tensor,      # [n_lookups] int32, which output bag each lookup joins
    n_bags: int,
    weights: torch.Tensor | None = None,   # optional per-lookup float32 weights
    mode: str = "sum",
    layout: SegmentLayout | None = None,   # segment_layout(bag_ids, n_bags)
) -> torch.Tensor:
    """Multi-hot bag reduction: ``out[b] = reduce_{i: bag_ids[i]==b} w_i *
    table[ids[i]]`` for mode sum, mean or max (an empty bag gives +0.0 for
    sum and mean, -inf for max)."""
    if mode not in ("sum", "mean", "max"):
        raise ValueError(mode)
    if layout is None:
        layout = segment_layout(bag_ids, n_bags)
    if mode == "max":
        vals = embedding_lookup(table, ids)
        if weights is not None:
            vals = vals * weights[:, None]
        return segment_reduce(vals.contiguous(), bag_ids, num_segments=n_bags,
                              reduce="max", layout=layout)
    if weights is None:
        weights = torch.ones(ids.shape, device=table.device)
    s = bag_sum(table, ids, bag_ids, weights, n_bags=n_bags, layout=layout)
    if mode == "sum":
        return s
    # each bag's kept lookups, exact in float32 below 2^24
    c = (layout.offsets[1:] - layout.offsets[:-1]).float()[:, None]
    return s / torch.clamp(c, min=1.0)

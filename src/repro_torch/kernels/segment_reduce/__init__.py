"""Segmented row reduction for GNN message aggregation (see ops.py)."""

from repro_torch.kernels.segment_reduce.ops import gather_rows, segment_reduce
from repro_torch.kernels.segment_reduce.ref import (
    SegmentLayout,
    segment_layout,
    segment_reduce_ref,
)

__all__ = ["SegmentLayout", "gather_rows", "segment_layout", "segment_reduce",
           "segment_reduce_ref"]

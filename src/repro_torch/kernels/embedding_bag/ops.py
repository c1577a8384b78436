"""Public wrapper for the embedding_bag kernel: the recsys bag sum.

Replaces ``repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_pallas``
(and its dispatching wrapper ``ops.embedding_bag_fused``). On a CUDA tensor
it launches the hand-written kernel (``csrc/embedding_bag.cu``,
``embedding_bag_run``); on a CPU tensor it runs the plain version
(``ref.py``); on a meta tensor it returns an empty one of the output's
shape (``kernels/_meta.py``), and the backward gives the gradients'
shapes. Any other device raises. The reference pads the lookups to
``BLOCK_L`` and sends tables over its VMEM budget to XLA; here every table
goes through the kernel, unpadded.

The layout is ``segment_reduce``'s: ``segment_layout(bags, n_bags)``, a
stable sort of the bag ids, computed here if not given (pass it to share
one sort among the calls on the same bags), or ``contiguous_layout`` for
bags that are contiguous runs of equal length, whose identity perm the
kernel does not read.

``embedding_bag`` is differentiable (a ``torch.autograd.Function``, entered
only when the table or the weights require a gradient). The
TPU kernel has no backward kernel, so the backward is plain PyTorch apart
from its sums:

* table: the rows ``weights[i] * g[bags[i]]`` summed by ``ids[i]`` in
  lookup order with ``segment_reduce``'s kernel (deterministic, as
  ``gather_rows`` is);
* weights (only when they require a gradient):
  ``<table[ids[i]], g[bags[i]]>``, summed over the columns in column order,
  so the card's gradient equals the CPU's bit for bit.

Dropped lookups contribute nothing to either gradient (the reference adds
their ``w * 0``, which differs only where ``w`` or the row is infinite).

Bound on the card: bytes (see the source note in ``csrc/embedding_bag.cu``).
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build, _meta
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.segment_reduce import (
    SegmentLayout,
    segment_layout,
    segment_reduce,
)


def _check_inputs(table, ids, bags, weights, n_bags, layout):
    if table.dtype != torch.float32 or table.dim() != 2:
        raise TypeError(f"table must be float32 [V, D], got {table.dtype} "
                        f"{tuple(table.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 1:
        raise TypeError(f"ids must be an int32 vector, got {ids.dtype} "
                        f"{tuple(ids.shape)}")
    if bags.dtype != torch.int32 or bags.shape != ids.shape:
        raise TypeError(f"bags must be int32 [{ids.shape[0]}], got "
                        f"{bags.dtype} {tuple(bags.shape)}")
    if weights.dtype != torch.float32 or weights.shape != ids.shape:
        raise TypeError(f"weights must be float32 [{ids.shape[0]}], got "
                        f"{weights.dtype} {tuple(weights.shape)}")
    if not (table.is_contiguous() and ids.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("table, ids and weights must be contiguous")
    device = table.device
    if (ids.device != device or bags.device != device
            or weights.device != device):
        raise ValueError(f"table, ids, bags and weights must share a device, "
                         f"got {device}, {ids.device}, {bags.device}, "
                         f"{weights.device}")
    if not (table.is_cuda or table.is_cpu or table.is_meta):
        raise ValueError(f"embedding_bag runs on cuda, cpu or meta tensors, "
                         f"not {device}")
    # a layout's own seg passed as the bags (as DIEN does) fits them
    if layout is not None and (layout.num_segments != n_bags
                               or layout.seg is not bags
                               and (layout.seg.shape != bags.shape
                                    or layout.seg.device != device)):
        raise ValueError(f"layout is for {layout.num_segments} bags and "
                         f"{layout.seg.shape[0]} lookups on "
                         f"{layout.seg.device}, not {n_bags} and "
                         f"{bags.shape[0]} on {table.device}")


def _launch(table, ids, weights, layout: SegmentLayout) -> torch.Tensor:
    """The bag sums: the kernel on CUDA, the plain version on the CPU,
    shapes only on meta."""
    n = layout.num_segments
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, layout.seg, weights, n_bags=n,
                                 layout=layout)
    if table.device.type == "meta":
        return _meta.embedding_bag(table, ids, weights, layout)
    lib = _build.load_library()
    out = torch.empty((n, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    # the raw handle of the current stream, and the device made current
    # only when it is not: the host's cost per call sets the time of the
    # small serving calls
    index = table.device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    guard = (contextlib.nullcontext() if index == torch.cuda.current_device()
             else torch.cuda.device(table.device))
    with guard:
        embedding_bag.launches += 1
        rc = lib.embedding_bag_run(
            n, table.shape[1], ids.shape[0], table.data_ptr(), ids.data_ptr(),
            weights.data_ptr(),
            None if layout.identity_perm else layout.perm.data_ptr(),
            layout.offsets.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, rc, "embedding_bag")
    return out


class _EmbeddingBag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, weights, ids, layout):
        ctx.save_for_backward(table, weights, ids)
        ctx.layout = layout
        return _launch(table, ids, weights, layout)

    @staticmethod
    def backward(ctx, g):
        table, weights, ids = ctx.saved_tensors
        layout = ctx.layout
        n, v = layout.num_segments, table.shape[0]
        kept = layout.seg < n
        # g[bags[i]], zero for the dropped lookups
        pad = torch.zeros((1, g.shape[1]), dtype=g.dtype, device=g.device)
        g_rows = torch.cat([g, pad]).index_select(0, layout.seg)
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            by_id = torch.where(kept, ids, torch.full_like(ids, v))
            d_table = segment_reduce(g_rows * weights[:, None], by_id,
                                     num_segments=v,
                                     layout=segment_layout(by_id, v))
        if ctx.needs_input_grad[1]:
            rows = table.index_select(0, torch.where(kept, ids,
                                                     torch.zeros_like(ids)))
            acc = torch.zeros_like(weights)
            for c in range(rows.shape[1]):
                acc = acc + rows[:, c] * g_rows[:, c]
            d_weights = torch.where(kept, acc, torch.zeros_like(acc))
        return d_table, d_weights, None, None


def embedding_bag(table, ids, bags, weights, *, n_bags: int,
                  layout: SegmentLayout | None = None) -> torch.Tensor:
    """``out[b] = sum_{bags[i] == b} weights[i] * table[ids[i]]``.

    table [V, D] float32, contiguous; ids and bags [L] int32 (ids in
    ``[0, V)`` wherever the bag is kept; bags outside ``[0, n_bags)``
    dropped); weights [L] float32. Returns [n_bags, D] float32, +0.0 for an
    empty bag. ``layout`` is ``segment_layout(bags, n_bags)``.
    """
    _check_inputs(table, ids, bags, weights, n_bags, layout)
    if layout is None:
        layout = segment_layout(bags, n_bags)
    if torch.is_grad_enabled() and (table.requires_grad
                                    or weights.requires_grad):
        return _EmbeddingBag.apply(table, weights, ids, layout)
    return _launch(table, ids, weights, layout)


embedding_bag.launches = 0

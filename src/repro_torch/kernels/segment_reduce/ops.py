"""Public wrapper for the segment_reduce kernel: GNN message aggregation.

Replaces ``repro/kernels/segment_reduce/segment_reduce.py::segment_reduce_pallas``.
On a CUDA tensor it launches the hand-written kernel
(``csrc/segment_reduce.cu``, ``segment_reduce_run``); on a CPU tensor it
runs the plain version (``ref.py``). Any other device raises.

``segment_reduce`` is differentiable (a ``torch.autograd.Function``). The
TPU kernel has no backward kernel, so the backward is plain PyTorch apart
from its sums, which go through this kernel again:

* sum: a gather of the upstream gradient by id; dropped ids get 0.
* min/max: the gradient is split equally among the entries equal to the
  result, as ``jax.grad`` of ``jax.ops.segment_min/max`` splits it (a
  segment left at its identity also counts the identity as one tie).

``gather_rows(h, idx, layout)`` is ``h[idx]`` whose backward is this
kernel's sum by ``idx``. PyTorch's own index backward scatters with atomics
on CUDA, which would make the card's gradients differ from run to run.

Bound on the card: bytes (see the source note in ``csrc/segment_reduce.cu``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.segment_reduce.ref import (
    IDENTITY,
    SegmentLayout,
    segment_layout,
    segment_reduce_ref,
)

# Reduce codes of csrc/segment_reduce.cu (enum Reduce).
REDUCE_CODES = {"sum": 0, "min": 1, "max": 2}


def _check_inputs(data, seg, num_segments, reduce, layout):
    if reduce not in REDUCE_CODES:
        raise ValueError(f"reduce must be one of {sorted(REDUCE_CODES)}, got "
                         f"{reduce!r}")
    if data.dtype != torch.float32 or data.dim() not in (1, 2):
        raise TypeError(f"data must be float32 [E] or [E, D], got "
                        f"{data.dtype} {tuple(data.shape)}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if seg.dtype != torch.int32 or seg.shape != data.shape[:1]:
        raise TypeError(f"seg must be int32 [{data.shape[0]}], got "
                        f"{seg.dtype} {tuple(seg.shape)}")
    if seg.device != data.device:
        raise ValueError(f"seg is on {seg.device}, data on {data.device}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_reduce runs on cuda or cpu tensors, not "
                         f"{data.device}")
    if layout is not None and (layout.num_segments != num_segments
                               or layout.seg.shape != seg.shape
                               or layout.seg.device != data.device):
        raise ValueError(f"layout is for {layout.num_segments} segments and "
                         f"{layout.seg.shape[0]} ids on {layout.seg.device}, "
                         f"not {num_segments} and {seg.shape[0]} on "
                         f"{data.device}")


def _launch(rows: torch.Tensor, layout: SegmentLayout, reduce: str):
    """The reduction of contiguous float32 ``rows`` [E, D]: the kernel on
    CUDA, the plain version on the CPU."""
    n = layout.num_segments
    if rows.device.type == "cpu":
        return segment_reduce_ref(rows, layout.seg, num_segments=n,
                                  reduce=reduce, layout=layout)
    lib = _build.load_library()
    out = torch.empty((n, rows.shape[1]), dtype=torch.float32,
                      device=rows.device)
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        segment_reduce.launches += 1
        rc = lib.segment_reduce_run(REDUCE_CODES[reduce], n, rows.shape[1],
                                    rows.data_ptr(), layout.perm.data_ptr(),
                                    layout.offsets.data_ptr(), out.data_ptr(),
                                    stream)
    _build.check(lib, rc, "segment_reduce")
    return out


def _gather_padded(rows: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """``rows[seg]`` with a zero row for the dropped id ``len(rows)``."""
    pad = torch.zeros((1, rows.shape[1]), dtype=rows.dtype, device=rows.device)
    return torch.cat([rows, pad]).index_select(0, seg)


class _SegmentReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, layout, reduce):
        out = _launch(rows, layout, reduce)
        ctx.layout, ctx.reduce = layout, reduce
        if reduce != "sum":
            ctx.save_for_backward(rows, out)
        return out

    @staticmethod
    def backward(ctx, g):
        layout, reduce = ctx.layout, ctx.reduce
        if reduce == "sum":
            return _gather_padded(g, layout.seg), None, None
        rows, out = ctx.saved_tensors
        nan = torch.full((1, out.shape[1]), float("nan"), device=out.device)
        hit = rows == torch.cat([out, nan]).index_select(0, layout.seg)
        ties = _launch(hit.float(), layout, "sum")
        ties = ties + (out == IDENTITY[reduce]).float()
        share = g * (1.0 / ties)
        # times 0/1, as JAX's transpose does (a miss keeps the share's sign)
        return _gather_padded(share, layout.seg) * hit.float(), None, None


def segment_reduce(data, seg, *, num_segments: int, reduce: str = "sum",
                   layout: SegmentLayout | None = None) -> torch.Tensor:
    """``out[v] = reduce_{seg[e]==v} data[e]``, reduce in {sum, min, max}.

    data [E] or [E, D] float32, contiguous; seg [E] int32, ids outside
    ``[0, num_segments)`` dropped. ``layout`` is ``segment_layout(seg,
    num_segments)``, computed here if not given: pass it to share one sort
    among the calls on the same ids. Returns [num_segments] or
    [num_segments, D] float32, the identity where no edge lands.
    """
    _check_inputs(data, seg, num_segments, reduce, layout)
    if layout is None:
        layout = segment_layout(seg, num_segments)
    rows = data if data.dim() == 2 else data[:, None]
    out = _SegmentReduce.apply(rows, layout, reduce)
    return out if data.dim() == 2 else out[:, 0]


segment_reduce.launches = 0


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, idx, layout):
        ctx.layout = layout
        return h.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        return _launch(g.contiguous(), ctx.layout, "sum"), None, None


def gather_rows(h: torch.Tensor, idx: torch.Tensor,
                layout: SegmentLayout) -> torch.Tensor:
    """``h[idx]`` for h [N, D] and int32 ids in ``[0, N)``; ``layout`` is
    ``segment_layout(idx, N)``, and the backward sums the gradient rows by
    ``idx`` in edge order with ``segment_reduce``'s kernel."""
    if layout.num_segments != h.shape[0] or layout.seg.shape != idx.shape:
        raise ValueError(f"layout is for {layout.num_segments} rows and "
                         f"{layout.seg.shape[0]} ids, not {h.shape[0]} and "
                         f"{idx.shape[0]}")
    if not h.requires_grad:
        return h.index_select(0, idx)
    return _GatherRows.apply(h, idx, layout)

"""Public wrapper for the segment_reduce kernel: GNN message aggregation.

Replaces ``repro/kernels/segment_reduce/segment_reduce.py::segment_reduce_pallas``.
On a CUDA tensor it launches the hand-written kernel
(``csrc/segment_reduce.cu``, ``segment_reduce_run``); on a CPU tensor it
runs the plain version (``ref.py``); on a meta tensor it returns an empty
one of the output's shape (``kernels/_meta.py``), and the backward below
gives the gradients' shapes. Any other device raises.

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
Gradient rows of another dtype (the LMs' bfloat16) are widened to float32,
summed and cast back once.

The kernel (see the source note in ``csrc/segment_reduce.cu``):

* What bounds it: bytes, read at random. Each edge's row is gathered by
  ``perm``; on an H100 a random row costs at least a 64-byte access, so
  small widths and hubs, not the adds, set the time.
* Tiles: a first small kernel cuts the sorted stream of edges and segments
  into tiles of equal length (a hub ends a tile of its own, runs of empty
  segments are spread like edges, and a small input gets short tiles so it
  still spreads over the card); one block reduces each tile. The
  tiles are kept in the layout (``SegmentLayout.tiles``, by width and
  stream), so every later call on that layout at that width is one
  launch.
* Staging: the block copies its perm entries, then every row of a chunk,
  into shared memory with ``cp.async``, so thousands of row loads are in
  flight instead of one dependent chain per segment; each row and perm
  entry is read once for all columns.
* Fills: threads write consecutive outputs, so empty segments are a flat
  vectorised fill of the identity.
* Order: each (segment, column) is still reduced by one thread in edge
  order from the identity. Parallel partial sums would round differently
  and break the bit-for-bit equality with the plain version and with
  ``jax.ops.segment_sum``; what the threads share is the loads, the columns
  and the segments.

Widths up to ``segment_reduce_max_width()`` of the library (19,368 columns:
two rows of a chunk must fit in a block's shared memory); a wider call on
the card raises ValueError.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build, _meta
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
    if data.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"segment_reduce runs on cuda, cpu or meta tensors, "
                         f"not {data.device}")
    if layout is not None and (layout.num_segments != num_segments
                               or layout.seg.shape != seg.shape
                               or layout.seg.device != data.device):
        raise ValueError(f"layout is for {layout.num_segments} segments and "
                         f"{layout.seg.shape[0]} ids on {layout.seg.device}, "
                         f"not {num_segments} and {seg.shape[0]} on "
                         f"{data.device}")


def _launch(rows: torch.Tensor, layout: SegmentLayout, reduce: str):
    """The reduction of contiguous float32 ``rows`` [E, D]: the kernel on
    CUDA, the plain version on the CPU, shapes only on meta."""
    n = layout.num_segments
    if rows.device.type == "cpu":
        return segment_reduce_ref(rows, layout.seg, num_segments=n,
                                  reduce=reduce, layout=layout)
    if rows.device.type == "meta":
        return _meta.segment_reduce(rows, layout)
    lib = _build.load_library()
    e, d = rows.shape
    out = torch.empty((n, d), dtype=torch.float32, device=rows.device)
    # the raw handle of the current stream, and the device made current
    # only when it is not: the host's cost per call sets the time of the
    # small shapes' steps
    stream = torch._C._cuda_getCurrentRawStream(rows.device.index)
    guard = (contextlib.nullcontext()
             if rows.device.index == torch.cuda.current_device()
             else torch.cuda.device(rows.device))
    with guard:
        start = _tiles(lib, layout, e, d, stream)
        segment_reduce.launches += 1
        rc = lib.segment_reduce_run(REDUCE_CODES[reduce], n, e, d,
                                    rows.data_ptr(), layout.perm.data_ptr(),
                                    layout.offsets.data_ptr(),
                                    start.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, rc, "segment_reduce")
    return out


def _tiles(lib, layout: SegmentLayout, e: int, d: int, stream: int):
    """The kernel's tile starts for ``layout`` at width ``d`` on ``stream``:
    computed by the tile kernel at the first call and kept in the layout."""
    start = layout.tiles.get((d, stream))
    if start is not None:
        return start
    n = layout.num_segments
    size = lib.segment_reduce_scratch(n, e, d)
    if size < 0:
        widest = lib.segment_reduce_max_width()
        if d > widest:
            raise ValueError(f"segment_reduce: width {d} is above the card "
                             f"kernel's limit of {widest} columns")
        raise ValueError(f"segment_reduce: {e} ids into {n} segments at width "
                         f"{d} need a tile scratch of 2^31 or more ints")
    start = torch.empty((size,), dtype=torch.int32, device=layout.offsets.device)
    rc = lib.segment_reduce_tiles(n, e, d, layout.offsets.data_ptr(),
                                  start.data_ptr(), stream)
    _build.check(lib, rc, "segment_reduce tiles")
    layout.tiles[(d, stream)] = start
    return start


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
    if torch.is_grad_enabled() and rows.requires_grad:
        out = _SegmentReduce.apply(rows, layout, reduce)
    else:   # no graph to record: skip autograd's cost per call
        out = _launch(rows, layout, reduce)
    return out if data.dim() == 2 else out[:, 0]


segment_reduce.launches = 0


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, idx, layout):
        ctx.layout = layout
        return h.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        rows = g.float().contiguous()
        return _launch(rows, ctx.layout, "sum").to(g.dtype), None, None


def gather_rows(h: torch.Tensor, idx: torch.Tensor,
                layout: SegmentLayout) -> torch.Tensor:
    """``h[idx]`` for h [N, D] and int32 ids in ``[0, N)``; ``layout`` is
    ``segment_layout(idx, N)``, and the backward sums the gradient rows by
    ``idx`` in edge order with ``segment_reduce``'s kernel, in float32
    (cast once to ``h``'s dtype). A layout of ids where some are outside
    ``[0, N)`` drops those rows' gradients: the rows are still gathered
    by ``idx``, but add nothing."""
    if layout.num_segments != h.shape[0] or layout.seg.shape != idx.shape:
        raise ValueError(f"layout is for {layout.num_segments} rows and "
                         f"{layout.seg.shape[0]} ids, not {h.shape[0]} and "
                         f"{idx.shape[0]}")
    if not h.requires_grad:
        return h.index_select(0, idx)
    return _GatherRows.apply(h, idx, layout)

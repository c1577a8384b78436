"""Public wrapper for the fused k-sweep relax kernel, with a lane axis.

Replaces ``repro/kernels/edge_relax_multi/edge_relax_multi.py::
relax_multi_pallas``. On CUDA tensors it launches the hand-written kernel
sequence of ``csrc/relax.cu`` (``relax_multi_run``: one prepare pass, then
k rounds of one scatter launch per edge block and one finish launch, with
no host sync inside the chunk); on CPU tensors it runs the plain version
(``ref.py``); on meta tensors it returns empty ones of the outputs' shapes
(``kernels/_meta.py``). Any other device raises.

Bound on the card: bytes. A sweep must read every edge's src; only edges
whose src is on some lane's frontier need their dst and w, a value gather
per lane and a min per (dst, lane); and the lanes' state (about 70 MB per
lane at N = 2^22, more than the L2) is read and written once. The design
replaced per-lane scatter launches over clones of the state: a prepare
pass packs the frontier into a bitmap (one bit per vertex) and, with more
lanes, a word of lane bits per vertex, so a shared block is read once for
all lanes and its dst and w only for frontier sources; a warp merges
equal-dst candidates before the one atomicMin; the finish writes fresh
outputs, so the caller's tensors are read, never copied or written, and
``parent`` is not touched unless parents are tracked. A chunk's first
round is the one dense pass over the lanes' state; later rounds update
the outputs in place, and their scatter marks, per lane and quad of
vertices, where it first wrote a best word (with one lane the finish
reads the best words themselves), so their finish visits only the marked
and frontier entries of the lanes that run. A sparse sweep,
the main path's usual one, then costs little more than one read of
every src and of the frontier's packed bits.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import _build, _meta
from repro_torch.kernels.edge_relax.ops import OP_CODES
from repro_torch.kernels.edge_relax.ref import ops_for
from repro_torch.kernels.edge_relax_multi.ref import relax_multi_ref


def _check_inputs(values, parent, frontier, blocks, num_nodes, k, work,
                  visits):
    if k < 1:
        raise ValueError(f"fused sweep count k={k} must be >= 1")
    if values.dim() != 2 or values.shape[1] != num_nodes:
        raise ValueError(f"values must be [lanes, {num_nodes}], got "
                         f"{tuple(values.shape)}")
    if parent.shape != values.shape or frontier.shape != values.shape:
        raise ValueError("values, parent and frontier must share one shape")
    if (values.dtype, parent.dtype, frontier.dtype) != (
            torch.float32, torch.int32, torch.bool):
        raise TypeError("values/parent/frontier must be float32/int32/bool, "
                        f"got {values.dtype}/{parent.dtype}/{frontier.dtype}")
    if not blocks:
        raise ValueError("relax_multi needs at least one edge block")
    lanes = values.shape[0]
    if work is not None and (work.shape != (lanes,)
                             or work.dtype != torch.float32
                             or work.device != values.device):
        raise ValueError(f"work must be float32 [{lanes}] on the state's "
                         f"device, got {work.dtype} {tuple(work.shape)}")
    if visits is not None and (visits.shape != (2,)
                               or visits.dtype != torch.int64
                               or visits.device != values.device):
        raise ValueError("visits must be int64 [2] on the state's device, "
                         f"got {visits.dtype} {tuple(visits.shape)}")
    for src, dst, w in blocks:
        if not (src.shape == dst.shape == w.shape) or src.dim() not in (1, 2):
            raise ValueError("each block's src/dst/w must share a [E] or "
                             f"[lanes, E] shape, got {tuple(src.shape)}")
        if src.dim() == 2 and src.shape[0] != lanes:
            raise ValueError(f"stacked block has {src.shape[0]} lanes, "
                             f"state has {lanes}")
        if (src.dtype, dst.dtype, w.dtype) != (torch.int32, torch.int32,
                                               torch.float32):
            raise TypeError("block src/dst/w must be int32/int32/float32")
        if any(t.device != values.device for t in (src, dst, w)):
            raise ValueError("edge blocks must be on the state's device")


def relax_multi(values, parent, frontier, blocks, allowed=None, *, op: str,
                num_nodes: int, k: int, track_parents: bool = True,
                work=None, visits=None):
    """Up to ``min(k, allowed[lane])`` frontier-masked sweeps per lane.

    values/parent/frontier ``[S, N]`` f32/int32/bool; ``blocks`` a sequence
    of ``(src, dst, w)``, each ``[E]`` (shared by every lane) or ``[S, E]``
    (one row per lane), dst == N marking padding; ``allowed`` an int or an
    int32 ``[S]`` tensor capping each lane's sweeps (default ``k``). Each
    sweep takes the best candidate per dst and the smallest winning src,
    applies the meet, sets the parent where improved and frontier =
    improved. Each sweep's work (its blocks' active edges, summed in
    block order in f32) is added to the lane's total, one sweep at a
    time, from ``work`` (f32 ``[S]``, default zeros). The rounds after
    the first update the outputs in place and visit only the entries that
    can change (see the module's note); where ``visits`` (int64 ``[2]``)
    is given, they add to it the entries they visited and the entries of
    the lanes that ran (what a dense pass would visit). Returns new
    ``(values, parent, frontier, sweeps [S] int32, work [S] f32)``. The
    inputs are never modified: on the card the kernel
    reads them and writes fresh outputs. Without parent tracking the
    returned ``parent`` equals the caller's; on the card it is the
    caller's tensor itself, not a copy.
    """
    ops_for(op)
    _check_inputs(values, parent, frontier, blocks, num_nodes, k, work,
                  visits)
    if values.device.type == "cpu":
        return relax_multi_ref(values, parent, frontier, blocks, allowed,
                               op=op, num_nodes=num_nodes, k=k,
                               track_parents=track_parents, work=work,
                               visits=visits)
    if values.device.type == "meta":
        return _meta.relax_multi(values, parent, frontier, blocks,
                                 track_parents, visits)
    if values.device.type != "cuda":
        raise ValueError(f"relax_multi runs on cuda, cpu or meta tensors, "
                         f"not {values.device}")
    lib = _build.load_library()
    dev = values.device
    lanes = values.shape[0]
    if lanes > lib.relax_multi_max_lanes():
        raise ValueError(f"relax_multi on cuda takes at most "
                         f"{lib.relax_multi_max_lanes()} lanes, got {lanes}")
    values, frontier = values.contiguous(), frontier.contiguous()
    if isinstance(allowed, torch.Tensor):
        cap = allowed.to(dev, torch.int32).expand(lanes).contiguous()
    else:
        cap = torch.full((lanes,), k if allowed is None else allowed,
                         dtype=torch.int32, device=dev)
    blocks = [tuple(t.contiguous() for t in blk) for blk in blocks]
    nb = len(blocks)
    # one zeroed int32 scratch: run flags [k+1, S+1] (the last entry of a
    # row: some frontier bit is set), sweeps [S], counts [S, nb], work [S]
    # (f32 zeros, or the caller's totals) and, unless the caller counts
    # them, the visit counters (int64 [2]); and one unset one: the best
    # words [S * N] (int64 when tracked), the vertex bitmap [ceil(N / 32)],
    # and, with more than one lane, the lane bits [ceil(S / 32) * N] and
    # the marks [ceil(S / 32) * ceil(N / 4)] (a word of lane bits per group
    # of 32 lanes and quad of vertices), which the kernel zeroes
    rows = (k + 1) * (lanes + 1)
    counts_at = rows + lanes
    work_at = counts_at + lanes * nb
    visits_at = (work_at + lanes + 1) // 2 * 2                     # 8 B
    zeroed = torch.zeros(visits_at + (4 if visits is None else 0),
                         dtype=torch.int32, device=dev)
    if work is not None:
        zeroed[work_at:work_at + lanes].view(torch.float32).copy_(work)
    if visits is None:
        visits = zeroed[visits_at:].view(torch.int64)
    bitmap_at = lanes * num_nodes * (2 if track_parents else 1)
    fbits_at = (bitmap_at + (num_nodes + 31) // 32 + 3) // 4 * 4  # 16 B
    fbits_len = (lanes + 31) // 32 * num_nodes if lanes > 1 else 0
    marks_at = fbits_at + fbits_len
    marks_len = (lanes + 31) // 32 * ((num_nodes + 3) // 4) if lanes > 1 else 0
    unset = torch.empty(marks_at + marks_len, dtype=torch.int32, device=dev)
    values_out = torch.empty_like(values)
    frontier_out = torch.empty_like(frontier)
    if track_parents:
        parent = parent.contiguous()
        parent_out = torch.empty_like(parent)
    else:
        parent_out = None
    srcs = _build.void_ptrs([b[0].data_ptr() for b in blocks])
    dsts = _build.void_ptrs([b[1].data_ptr() for b in blocks])
    ws = _build.void_ptrs([b[2].data_ptr() for b in blocks])
    lens = _build.longlongs([b[0].shape[-1] for b in blocks])
    strides = _build.longlongs([b[0].shape[-1] if b[0].dim() == 2 else 0
                                for b in blocks])
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    guard = (contextlib.nullcontext()
             if dev.index == torch.cuda.current_device()
             else torch.cuda.device(dev))
    with guard:
        relax_multi.launches += 1
        rc = lib.relax_multi_run(
            OP_CODES[op], int(track_parents), lanes, num_nodes, k,
            values.data_ptr(), parent.data_ptr() if track_parents else None,
            frontier.data_ptr(), values_out.data_ptr(),
            parent_out.data_ptr() if track_parents else None,
            frontier_out.data_ptr(), nb, srcs, dsts, ws, lens, strides,
            cap.data_ptr(), zeroed[:rows].data_ptr(),
            zeroed[rows:counts_at].data_ptr(), zeroed[work_at:].data_ptr(),
            unset.data_ptr(), unset[bitmap_at:].data_ptr(),
            unset[fbits_at:].data_ptr() if fbits_len else None,
            unset[marks_at:].data_ptr() if fbits_len else None,
            zeroed[counts_at:work_at].data_ptr(),
            visits.data_ptr(), stream)
    _build.check(lib, rc, "relax_multi")
    return (values_out, parent_out if track_parents else parent, frontier_out,
            zeroed[rows:counts_at],
            zeroed[work_at:work_at + lanes].view(torch.float32))


relax_multi.launches = 0

"""Public wrapper for the fused k-sweep relax kernel, with a lane axis.

Replaces ``repro/kernels/edge_relax_multi/edge_relax_multi.py::
relax_multi_pallas``. On CUDA tensors it launches the hand-written kernel
sequence of ``csrc/relax.cu`` (``relax_multi_run``: one init, then k rounds
of one scatter launch per edge block and one finish launch, with no host
sync inside the chunk); on CPU tensors it runs the plain version
(``ref.py``). Any other device raises.

Bound on the card: bytes. A sweep reads every edge of every block once
(12 bytes), gathers frontier and values at random and issues one atomicMin
per active edge; per lane, values/parent/frontier and the packed
best/winner words (about 70 MB at N = 2^22) stay in device memory, since
they fit neither shared memory nor L2. The design skips inactive edges
before the value gather and reads the best word before the atomic, so a
sweep's cost follows its active edges.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.edge_relax.ops import OP_CODES
from repro_torch.kernels.edge_relax.ref import ops_for
from repro_torch.kernels.edge_relax_multi.ref import relax_multi_ref


def _check_inputs(values, parent, frontier, blocks, num_nodes, k):
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
                num_nodes: int, k: int, track_parents: bool = True):
    """Up to ``min(k, allowed[lane])`` frontier-masked sweeps per lane.

    values/parent/frontier ``[S, N]`` f32/int32/bool; ``blocks`` a sequence
    of ``(src, dst, w)``, each ``[E]`` (shared by every lane) or ``[S, E]``
    (one row per lane), dst == N marking padding; ``allowed`` an int or an
    int32 ``[S]`` tensor capping each lane's sweeps (default ``k``). Each
    sweep takes the best candidate per dst and the smallest winning src,
    applies the meet, sets the parent where improved and frontier =
    improved. Returns new ``(values, parent, frontier, sweeps [S] int32,
    work [S] f32)``; the inputs are not modified.
    """
    ops_for(op)
    _check_inputs(values, parent, frontier, blocks, num_nodes, k)
    if values.device.type == "cpu":
        return relax_multi_ref(values, parent, frontier, blocks, allowed,
                               op=op, num_nodes=num_nodes, k=k,
                               track_parents=track_parents)
    if values.device.type != "cuda":
        raise ValueError(f"relax_multi runs on cuda or cpu tensors, not "
                         f"{values.device}")
    lib = _build.load_library()
    dev = values.device
    lanes = values.shape[0]
    # the kernel updates the state in place: work on contiguous copies
    values, parent, frontier = (t.clone(memory_format=torch.contiguous_format)
                                for t in (values, parent, frontier))
    cap = torch.as_tensor(k if allowed is None else allowed,
                          dtype=torch.int32, device=dev)
    cap = cap.expand(lanes).contiguous()
    blocks = [tuple(t.contiguous() for t in blk) for blk in blocks]
    nb = len(blocks)
    # one zeroed int32 scratch: run flags [(k+1), S], sweeps [S], counts [S, nb]
    scratch = torch.zeros((k + 1) * lanes + lanes + lanes * nb,
                          dtype=torch.int32, device=dev)
    flags = scratch[:(k + 1) * lanes]
    sweeps = scratch[(k + 1) * lanes:(k + 2) * lanes]
    counts = scratch[(k + 2) * lanes:]
    work = torch.zeros(lanes, dtype=torch.float32, device=dev)
    best = torch.empty(lanes * num_nodes,
                       dtype=torch.int64 if track_parents else torch.int32,
                       device=dev)
    srcs = _build.void_ptrs([b[0].data_ptr() for b in blocks])
    dsts = _build.void_ptrs([b[1].data_ptr() for b in blocks])
    ws = _build.void_ptrs([b[2].data_ptr() for b in blocks])
    lens = _build.longlongs([b[0].shape[-1] for b in blocks])
    strides = _build.longlongs([b[0].shape[-1] if b[0].dim() == 2 else 0
                                for b in blocks])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        relax_multi.launches += 1
        rc = lib.relax_multi_run(
            OP_CODES[op], int(track_parents), lanes, num_nodes, k,
            values.data_ptr(), parent.data_ptr(), frontier.data_ptr(), nb,
            srcs, dsts, ws, lens, strides, cap.data_ptr(), flags.data_ptr(),
            sweeps.data_ptr(), work.data_ptr(), best.data_ptr(),
            counts.data_ptr(), stream)
    _build.check(lib, rc, "relax_multi")
    return values, parent, frontier, sweeps, work


relax_multi.launches = 0

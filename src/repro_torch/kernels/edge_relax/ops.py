"""Public wrapper for the edge_relax kernel: one unmasked semiring sweep.

Replaces ``repro/kernels/edge_relax/edge_relax.py::edge_relax_pallas``. On
a CUDA tensor it launches the hand-written kernel (``csrc/relax.cu``,
``edge_relax_run``: fill, scatter, decode); on a CPU tensor it runs the
plain version (``ref.py``). Any other device raises.

Bound on the card: bytes — each edge is read once (12 bytes) plus a random
4-byte gather and one 32-bit atomicMin on the destination's word; the
design keeps the per-vertex best as an order-mapped u32 key so one atomic
instruction reduces any of the five semirings.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.edge_relax.ref import edge_relax_ref, ops_for

# Op codes of csrc/relax.cu (enum Op).
OP_CODES = {"min_plus": 0, "min_plus_unit": 1, "max_min": 2, "min_max": 3,
            "max_times": 4}


def _check_inputs(values, src, dst, w, num_nodes):
    if values.dim() != 1 or values.shape[0] != num_nodes:
        raise ValueError(f"values must be [{num_nodes}], got "
                         f"{tuple(values.shape)}")
    if not (src.shape == dst.shape == w.shape) or src.dim() != 1:
        raise ValueError(f"src/dst/w must be equal-length vectors, got "
                         f"{tuple(src.shape)}, {tuple(dst.shape)}, "
                         f"{tuple(w.shape)}")
    for name, t, dtype in (("values", values, torch.float32),
                           ("src", src, torch.int32),
                           ("dst", dst, torch.int32),
                           ("w", w, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != values.device:
            raise ValueError(f"{name} is on {t.device}, values on "
                             f"{values.device}")


def edge_relax(values, src, dst, w, *, op: str, num_nodes: int):
    """``out[v] = reduce_{dst[e]==v} combine(values[src[e]], w[e])``.

    values [N] f32; src/dst [E] int32 with dst == N marking padding; w [E]
    f32. Returns [N] f32, the semiring identity where no edge lands.
    """
    ops_for(op)
    _check_inputs(values, src, dst, w, num_nodes)
    if values.device.type == "cpu":
        return edge_relax_ref(values, src, dst, w, op=op, num_nodes=num_nodes)
    if values.device.type != "cuda":
        raise ValueError(f"edge_relax runs on cuda or cpu tensors, not "
                         f"{values.device}")
    lib = _build.load_library()
    values, src, dst, w = (t.contiguous() for t in (values, src, dst, w))
    out = torch.empty(num_nodes, dtype=torch.float32, device=values.device)
    best = torch.empty(num_nodes, dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        edge_relax.launches += 1
        rc = lib.edge_relax_run(OP_CODES[op], num_nodes, values.data_ptr(),
                                src.data_ptr(), dst.data_ptr(), w.data_ptr(),
                                src.shape[0], best.data_ptr(), out.data_ptr(),
                                stream)
    _build.check(lib, rc, "edge_relax")
    return out


edge_relax.launches = 0

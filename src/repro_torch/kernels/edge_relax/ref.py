"""Plain PyTorch version of the edge_relax kernel, and the semiring op table.

    out[v] = reduce_{e : dst[e]==v} combine(values[src[e]], w[e])

The wrapper (``ops.py``) runs this for tensors on the CPU; the CUDA kernel
is held against it on the card. Empty segments give the semiring identity,
as ``repro.kernels.edge_relax.ref.edge_relax_ref`` clamps them to.
"""

from __future__ import annotations

import math

import torch

FLT_MIN = torch.finfo(torch.float32).tiny


def flush_denormals(x: torch.Tensor) -> torch.Tensor:
    """Flush results below FLT_MIN in magnitude to a zero of the same sign.

    The JAX reference computes with flush-to-zero on the CPU, so this is
    applied inside the ``max_times`` combine — the only combine whose
    results can underflow (inputs are never denormal, since every result
    is flushed).
    """
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


SEMIRING_OPS = {
    # name: (combine, reduce-kind, identity)
    "min_plus": (lambda v, w: v + w, "min", math.inf),
    "min_plus_unit": (lambda v, w: v + 1.0, "min", math.inf),  # BFS: unit cost
    "max_min": (lambda v, w: torch.minimum(v, w), "max", -math.inf),
    "min_max": (lambda v, w: torch.maximum(v, w), "min", math.inf),
    "max_times": (lambda v, w: flush_denormals(v * w), "max", 0.0),
}

# Engine semiring name -> kernel op name. One entry per ALL_SEMIRINGS member.
KERNEL_OP_FOR = {
    "bfs": "min_plus_unit",
    "sssp": "min_plus",
    "sswp": "max_min",
    "ssnp": "min_max",
    "viterbi": "max_times",
}


class UnsupportedSemiring(KeyError):
    """A kernel was asked for a semiring op it has no lowering for."""


def ops_for(op: str):
    """Resolve ``op`` in SEMIRING_OPS, raising loudly on unknown names."""
    try:
        return SEMIRING_OPS[op]
    except KeyError as exc:
        raise UnsupportedSemiring(
            f"no kernel lowering for semiring op {op!r}; known ops: "
            f"{sorted(SEMIRING_OPS)}") from exc


def edge_relax_ref(values, src, dst, w, *, op: str, num_nodes: int):
    """values [N] f32; src/dst [E] int32 (dst == N for padding); w [E] f32.

    Returns the [N] reduced candidate vector; the sentinel row N that
    absorbs padding edges is dropped.
    """
    combine, reduce_kind, ident = ops_for(op)
    cand = combine(values[src.long()], w)
    out = torch.full((num_nodes + 1,), ident, dtype=torch.float32,
                     device=values.device)
    out.scatter_reduce_(0, dst.long(), cand,
                        reduce="amin" if reduce_kind == "min" else "amax")
    return out[:num_nodes]

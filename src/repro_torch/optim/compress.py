"""Gradient compression: int8 quantization with error feedback.

Counterpart of ``repro.optim.compress``, with its order of operations, so
the results are equal bit for bit: a per-tensor symmetric scale
``max(max |x|, 1e-12) / 127`` in float32, ``round`` half to even (as
``jnp.round``), clipped to [-127, 127]. With error feedback the residual
of each step's quantization is added to the next step's gradient
(Karimireddy et al., arXiv:1901.09847), which cuts a cross-pod gradient
all-reduce's bytes 4x. Here the value path is modelled exactly: the
caller reduces the (conceptually int8) payload.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization. Returns ``(q, scale)``."""
    x32 = x.float()
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress_update(grads, residuals):
    """Error-feedback compression of a gradient tree: ``(grads compressed
    and decompressed, in their dtypes, new float32 residuals)``."""
    comp, new_res = [], []
    for g, r in zip(tree_leaves(grads), tree_leaves(residuals)):
        g32 = g.float() + r
        deq = decompress_int8(*compress_int8(g32))
        comp.append(deq.to(g.dtype))
        new_res.append(g32 - deq)
    return tree_unflatten(grads, comp), tree_unflatten(grads, new_res)


def init_residuals(grads_like):
    """Float32 zeros shaped like each leaf of ``grads_like``, on its
    device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)

"""AdamW with f32 state + global-norm clipping, as ``repro.optim.adamw``.

The math is the reference's, step for step: clip the gradients by their
global norm (``max_norm / max(norm, 1e-9)``, at most 1), then a
bias-corrected AdamW step with eps added to ``sqrt(v_hat)`` and the decay
applied to the parameter before the step. ``torch.optim.AdamW`` with
``clip_grad_norm_`` places eps and the clip floor differently, so it is not
used. Updates are functional: new tensors, inputs untouched.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def adamw_init(params) -> AdamWState:
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"
    return AdamWState(tree_map(f32, params), tree_map(f32, params),
                      torch.zeros((), dtype=torch.int32, device=device))


def global_norm_clip(grads, max_norm: float):
    leaves = tree_leaves(grads)
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    max_norm: float = 1.0,
):
    """Returns ``(new_params, new_state, grad_norm)``."""
    grads, gnorm = global_norm_clip(grads, max_norm)
    count = state.count + 1
    t = count.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    new_m = tree_map(lambda g, m: b1 * m + (1 - b1) * g.float(),
                     grads, state.m)
    new_v = tree_map(lambda g, v: b2 * v + (1 - b2) * torch.square(g.float()),
                     grads, state.v)
    new_params = tree_map(
        lambda p, m, v: (p.float()
                         - lr * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                                 + weight_decay * p.float())).to(p.dtype),
        params, new_m, new_v)
    return new_params, AdamWState(new_m, new_v, count), gnorm

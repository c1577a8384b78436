"""AdamW with f32 state + global-norm clipping, as ``repro.optim.adamw``.

The math is the reference's, step for step: clip the gradients by their
global norm (``max_norm / max(norm, 1e-9)``, at most 1), then a
bias-corrected AdamW step with eps added to ``sqrt(v_hat)`` and the decay
applied to the parameter before the step. Parameters may be bfloat16: each
is updated in float32 and cast back, ``m`` and ``v`` are float32.
``torch.optim.AdamW`` with ``clip_grad_norm_`` places eps and the clip
floor differently, so it is not used. Updates are functional: new tensors,
inputs untouched. They go leaf by leaf, so beside the old and new
parameters, ``m`` and ``v`` (and the caller's gradients) only one leaf's
clipped gradient and float32 temporaries live at a time.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


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


def _clip_scale(leaves, max_norm: float):
    """(scale, norm): the global norm of ``leaves`` and the factor that
    clips it to ``max_norm``."""
    sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
    norm = torch.sqrt(sq)
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0), norm


def _clip(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (g.float() * scale).to(g.dtype)


def global_norm_clip(grads, max_norm: float):
    scale, norm = _clip_scale(tree_leaves(grads), max_norm)
    return tree_map(lambda g: _clip(g, scale), grads), norm


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
    g_leaves = tree_leaves(grads)
    scale, gnorm = _clip_scale(g_leaves, max_norm)
    count = state.count + 1
    t = count.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    new_m, new_v, new_p = [], [], []
    for g, m, v, p in zip(g_leaves, tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        # b1 m + (1 - b1) g, b2 v + (1 - b2) g^2, and
        # p - lr ((m / bc1) / (sqrt(v / bc2) + eps) + wd p), each product
        # and sum as the reference forms it, in place where a temporary
        # is the operand
        g = _clip(g, scale).float()
        m = torch.mul(m, b1).add_(g * (1 - b1))
        v = torch.mul(v, b2).add_(torch.square(g).mul_(1 - b2))
        del g
        p32 = p.float()
        step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        step.add_(p32 * weight_decay).mul_(lr)
        new_p.append((p32 - step).to(p.dtype))
        del p32, step
        new_m.append(m)
        new_v.append(v)
    return (tree_unflatten(params, new_p),
            AdamWState(tree_unflatten(state.m, new_m),
                       tree_unflatten(state.v, new_v), count), gnorm)

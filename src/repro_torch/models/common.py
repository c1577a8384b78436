"""Shared NN building blocks of the GNN and recsys families: initializers,
MLPs, norms, losses.

Counterpart of ``repro.models.common``. Parameters are plain dicts of leaf
tensors; initializers draw from an explicit ``torch.Generator`` on the
device the parameters live on, so their numbers differ from
``jax.random``'s for the same seed (tests carry the JAX package's weights
across with ``interop.params_from_arrays``). Everything is float32.

Left out: the latent-sharding hooks ``_lat`` and ``latent_constrainer``,
which do nothing on one card; the LM helpers ``rms_norm``, ``swiglu``,
``squared_relu_ffn`` and ``embed_init`` wait for the LM slice.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    """A [d_in, d_out] float32 weight, N(0, 1) times ``scale`` (default
    1/sqrt(d_in)), on ``gen``'s device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return w * scale


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


def mlp_params(gen: torch.Generator, dims: tuple[int, ...],
               norm: bool = False) -> dict:
    """``{"layers": [{"w", "b"}, ...]}`` for widths ``dims``, plus a final
    layer norm's ``ln_g``/``ln_b`` when ``norm``."""
    layers = [{"w": dense_init(gen, a, b),
               "b": torch.zeros((b,), device=gen.device)}
              for a, b in zip(dims[:-1], dims[1:])]
    p = {"layers": layers}
    if norm:
        p["ln_g"] = torch.ones((dims[-1],), device=gen.device)
        p["ln_b"] = torch.zeros((dims[-1],), device=gen.device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, act: Callable = torch.relu,
              final_act: bool = False) -> torch.Tensor:
    n = len(p["layers"])
    for i, lyr in enumerate(p["layers"]):
        x = x @ lyr["w"] + lyr["b"]
        if i < n - 1 or final_act:
            x = act(x)
    if "ln_g" in p:
        x = layer_norm(x, p["ln_g"], p["ln_b"])
    return x


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid labels (label < 0 is masked)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(
        logits, labels.clamp(min=0).long()[..., None], dim=-1)[..., 0]
    mask = labels >= 0
    nll = torch.where(mask, lse - ll, torch.zeros((), device=logits.device))
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))

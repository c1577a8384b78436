"""Shared NN building blocks: initializers, MLPs, norms, losses, and the
LM family's norm and FFNs.

Counterpart of ``repro.models.common``. Parameters are plain dicts of leaf
tensors; initializers draw from an explicit ``torch.Generator`` on the
device the parameters live on, so their numbers differ from
``jax.random``'s for the same seed (tests carry the JAX package's weights
across with ``interop.params_from_arrays``). The GNN and recsys helpers
are float32. The LM helpers (``embed_init``, ``rms_norm``, ``swiglu``,
``squared_relu_ffn``) keep their input's dtype as the reference's do: they
compute in float32 and cast back, and ``matmul_f32`` is the reference's
``jnp.dot(..., preferred_element_type=jnp.float32)``.

Left out: the latent-sharding hooks ``_lat`` and ``latent_constrainer``,
which do nothing on one card.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None) -> torch.Tensor:
    """A [d_in, d_out] float32 weight, N(0, 1) times ``scale`` (default
    1/sqrt(d_in)), on ``gen``'s device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return w * scale


# Float32 draws per block of ``normal_init``: 2^28 of them, 1 GiB.
_DRAW_BLOCK = 1 << 28


def normal_init(gen: torch.Generator | None, shape: tuple[int, ...],
                scale: float, dtype: torch.dtype = torch.float32,
                device: str | torch.device | None = None) -> torch.Tensor:
    """A ``dtype`` tensor of N(0, 1) draws times ``scale``, on ``device``
    (default ``gen``'s). Drawn in float32 a block of rows at a time, so a
    large bfloat16 weight never has a float32 copy of its own size; on the
    meta device nothing is drawn (``gen`` may be None)."""
    device = torch.device(device if device is not None else gen.device)
    out = torch.empty(shape, dtype=dtype, device=device)
    if device.type == "meta":
        return out
    rows = out.view(-1, shape[-1])
    step = max(1, _DRAW_BLOCK // shape[-1])
    for lo in range(0, rows.shape[0], step):
        block = rows[lo:lo + step]
        block.copy_(torch.randn(block.shape, generator=gen, device=device)
                    * scale)
    return out


def embed_init(gen: torch.Generator | None, vocab: int, d: int,
               dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None) -> torch.Tensor:
    """A [vocab, d] embedding table, N(0, 1) times 0.02, in ``dtype``."""
    return normal_init(gen, (vocab, d), 0.02, dtype, device)


class _MatmulF32(torch.autograd.Function):
    """``torch.mm``/``torch.bmm`` of two bfloat16 operands with
    ``out_dtype=torch.float32``, differentiable (PyTorch has no derivative
    for that overload). The backward is JAX's transpose of a
    ``preferred_element_type=jnp.float32`` dot: each operand's gradient is
    the float32 product of the float32 cotangent and the other operand
    widened to float32, cast once to the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().mT, g).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with a float32 result for 2-D or batched 3-D operands:
    the reference's ``preferred_element_type=jnp.float32``. Float32
    operands multiply as they are; bfloat16 ones on the card go through
    ``torch.mm``/``torch.bmm`` with ``out_dtype=torch.float32`` (products
    accumulated and returned in float32, no bfloat16 rounding of the
    result; through ``_MatmulF32``, differentiable), and on the CPU,
    whose build has no such overload, are widened first (a bfloat16
    product is exact in float32, so only the order of the float32 sums
    differs). Operands of two dtypes are both widened, as JAX promotes
    them."""
    if a.device.type == "cuda" and a.dtype == b.dtype != torch.float32:
        return _MatmulF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (y * gamma.float()).to(x.dtype)


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``jnp.dot(x, w, preferred_element_type=f32)`` for x [..., d], w
    [d, f]: a float32 [..., f]."""
    return matmul_f32(x.reshape(-1, x.shape[-1]), w).reshape(
        x.shape[:-1] + (w.shape[-1],))


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = (F.silu(_dot(x, w_gate)) * _dot(x, w_up)).to(x.dtype)
    return _dot(h, w_down).to(x.dtype)


def squared_relu_ffn(x: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor) -> torch.Tensor:
    """Nemotron-4 style FFN: squared-ReLU activation (arXiv:2402.16819)."""
    h = torch.square(torch.relu(_dot(x, w_up))).to(x.dtype)
    return _dot(h, w_down).to(x.dtype)


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


class _SoftmaxCrossEntropy(torch.autograd.Function):
    """The mean cross entropy of float32 logits [..., V] over the labels
    that are not masked, whose backward forms the gradient in one tensor
    of the logits' size: ``exp(x - lse) * w`` less ``w`` at each label,
    ``w`` the upstream gradient over the valid count on a valid row and 0
    on a masked one (JAX's gradient of ``logsumexp`` less the label's
    logit, the same bits as autograd's). Autograd's own backward of these
    operations holds three temporaries of the logits' size: for an LM
    step's 16,384 x 151,936 logits, 9.3 GiB each."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse = torch.logsumexp(logits, dim=-1)
        idx = labels.clamp(min=0).long()[..., None]
        ll = torch.take_along_dim(logits, idx, dim=-1)[..., 0]
        mask = labels >= 0
        zero = torch.zeros((), device=logits.device)
        count = torch.clamp(torch.sum(mask), min=1)
        ctx.save_for_backward(logits, lse, idx, mask, count)
        return torch.sum(torch.where(mask, lse - ll, zero)) / count

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, mask, count = ctx.saved_tensors
        zero = torch.zeros((), device=g.device)
        w = torch.where(mask, g / count, zero)[..., None]
        grad = (logits - lse[..., None]).exp_().mul_(w)
        # one label a row: written back, no atomic add on the card
        return grad.scatter_(-1, idx, grad.gather(-1, idx) - w), None


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over valid labels (label < 0 is masked); differentiable,
    see ``_SoftmaxCrossEntropy``."""
    return _SoftmaxCrossEntropy.apply(logits.float(), labels)


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))

"""Monotone path semirings for the five paper algorithms (PyTorch port).

Every algorithm in the paper (BFS, SSSP, SSWP, SSNP, Viterbi) is a fixpoint of

    val[v]  =  reduce_{(u,v,w) in E}  combine(val[u], w)      (+ source anchor)

where ``reduce`` is ``min`` or ``max`` and ``combine`` is monotone w.r.t. the
reduce order. Counterpart of ``repro.graph.semiring``; the combiners act on
torch tensors.

Denormals: the JAX reference runs with flush-to-zero, so a Viterbi product
that underflows below ``FLT_MIN`` becomes zero there. The port flushes
explicitly inside the ``max_times`` combine (here, in the plain kernel
versions and in the CUDA kernel) instead of setting a process-wide
``torch.set_flush_denormal``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.kernels.edge_relax.ref import flush_denormals

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Semiring:
    """A monotone path semiring.

    Attributes:
      name: short identifier (matches the paper's algorithm names).
      reduce: "min" or "max" — the vertex-side reduction order.
      identity: the "unreached" value (absorbing for reduce).
      source_value: value anchored at the source vertex.
      combine: (val_u, w) -> candidate value along edge (u, v, w).
      needs_weights: False for BFS (weights ignored).
    """

    name: str
    reduce: str
    identity: float
    source_value: float
    combine: Callable[[Tensor, Tensor], Tensor]
    needs_weights: bool = True

    @property
    def is_min(self) -> bool:
        return self.reduce == "min"

    def better(self, a: Tensor, b: Tensor) -> Tensor:
        """Elementwise meet: the better of two values under the reduce order."""
        return torch.minimum(a, b) if self.is_min else torch.maximum(a, b)

    def strictly_better(self, a: Tensor, b: Tensor) -> Tensor:
        """True where ``a`` is strictly better than ``b``."""
        return (a < b) if self.is_min else (a > b)


_INF = math.inf

BFS = Semiring(
    name="bfs",
    reduce="min",
    identity=_INF,
    source_value=0.0,
    combine=lambda val_u, w: val_u + 1.0,
    needs_weights=False,
)

SSSP = Semiring(
    name="sssp",
    reduce="min",
    identity=_INF,
    source_value=0.0,
    combine=lambda val_u, w: val_u + w,
)

# Single-source widest path: maximize, over paths, the minimum edge weight.
SSWP = Semiring(
    name="sswp",
    reduce="max",
    identity=-_INF,
    source_value=_INF,
    combine=lambda val_u, w: torch.minimum(val_u, w),
)

# Single-source narrowest path: minimize, over paths, the maximum edge weight.
SSNP = Semiring(
    name="ssnp",
    reduce="min",
    identity=_INF,
    source_value=-_INF,
    combine=lambda val_u, w: torch.maximum(val_u, w),
)

# Viterbi: maximize the product of edge probabilities in (0, 1]; products
# below FLT_MIN flush to zero, as in the reference.
VITERBI = Semiring(
    name="viterbi",
    reduce="max",
    identity=0.0,
    source_value=1.0,
    combine=lambda val_u, w: flush_denormals(val_u * w),
)

ALL_SEMIRINGS: dict[str, Semiring] = {
    s.name: s for s in (BFS, SSSP, SSWP, SSNP, VITERBI)
}

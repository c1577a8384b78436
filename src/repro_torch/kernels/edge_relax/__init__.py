"""One unmasked semiring edge-relax sweep (see ops.py)."""

from repro_torch.kernels.edge_relax.ops import edge_relax
from repro_torch.kernels.edge_relax.ref import edge_relax_ref

__all__ = ["edge_relax", "edge_relax_ref"]

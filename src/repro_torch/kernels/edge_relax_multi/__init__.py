"""Fused k-sweep frontier-masked relax kernel with a lane axis (see ops.py)."""

from repro_torch.kernels.edge_relax_multi.ops import relax_multi
from repro_torch.kernels.edge_relax_multi.ref import relax_multi_ref

__all__ = ["relax_multi", "relax_multi_ref"]

"""Hand-written CUDA kernels of the port, each with its plain PyTorch version.

Counterpart of ``repro.kernels``: every kernel directory holds ``ops.py``
(the wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors, a launch counter) and ``ref.py`` (the plain version). The CUDA
sources live in ``csrc/`` and are built by ``_build.py`` at first use.
"""

from repro_torch.kernels.edge_relax.ops import edge_relax
from repro_torch.kernels.edge_relax_multi.ops import relax_multi
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.segment_reduce.ops import segment_reduce

__all__ = ["edge_relax", "embedding_bag", "relax_multi", "segment_reduce"]

"""Weighted bag sum of table rows, the recsys EmbeddingBag (see ops.py)."""

from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_ref"]

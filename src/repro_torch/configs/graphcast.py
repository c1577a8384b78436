"""GraphCast [arXiv:2212.12794]: 16-layer processor d=512, sum aggregation,
n_vars=227, encode(grid->mesh)/process/decode(mesh->grid)."""
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="graphcast", arch="graphcast", n_layers=16, d_hidden=512,
    d_in=227, d_out=227, task="node_reg", aggregator="sum", n_vars=227,
)
FAMILY = "gnn"

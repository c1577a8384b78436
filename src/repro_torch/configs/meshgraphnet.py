"""MeshGraphNet [arXiv:2010.03409]: 15 MP blocks d=128, sum agg, 2-layer MLPs."""
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="meshgraphnet", arch="meshgraphnet", n_layers=15, d_hidden=128,
    d_in=0, d_out=3, task="node_reg", aggregator="sum", mlp_layers=2,
)
FAMILY = "gnn"

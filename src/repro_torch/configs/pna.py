"""PNA [arXiv:2004.05718]: 4 layers d=75, aggregators mean/max/min/std,
scalers identity/amplification/attenuation."""
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="pna", arch="pna", n_layers=4, d_hidden=75,
    d_in=0, d_out=0, task="node_class",  # bound per shape
)
FAMILY = "gnn"

"""GCN (Kipf & Welling) [arXiv:1609.02907]: 2 layers d=16, mean/sym-norm."""
from repro_torch.models.gnn import GNNConfig

CONFIG = GNNConfig(
    name="gcn-cora", arch="gcn", n_layers=2, d_hidden=16,
    d_in=1433, d_out=7, task="node_class",
)
FAMILY = "gnn"

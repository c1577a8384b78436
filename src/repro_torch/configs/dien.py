"""DIEN [arXiv:1809.03672]: embed 18, seq 100, GRU 108, MLP 200-80, AUGRU."""
from repro_torch.models.dien import DIENConfig

CONFIG = DIENConfig(
    name="dien", n_items=1 << 23, n_cats=10_000, embed_dim=18,
    seq_len=100, gru_dim=108, mlp_dims=(200, 80),
)
FAMILY = "recsys"

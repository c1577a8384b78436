"""Nemotron-4-340B [arXiv:2402.16819]: 96L d=18432 96H(kv=8) d_ff=73728,
squared-ReLU FFN, vocab 256000."""
import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="nemotron-4-340b",
    n_layers=96, d_model=18_432, n_heads=96, n_kv_heads=8, d_head=192,
    d_ff=73_728, vocab=256_000,
    activation="squared_relu", param_dtype=torch.bfloat16,
)
FAMILY = "lm"

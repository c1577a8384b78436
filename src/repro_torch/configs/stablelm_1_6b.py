"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b]: 24L d=2048 32H(kv=32) d_ff=5632."""
import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="stablelm-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=5632, vocab=100_352,
    activation="swiglu", param_dtype=torch.bfloat16,
)
FAMILY = "lm"

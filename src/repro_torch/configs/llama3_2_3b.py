"""Llama-3.2-3B [hf:meta-llama/Llama-3.2-3B]: 28L d=3072 24H(kv=8) d_ff=8192."""
import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="llama3.2-3b",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=128_256,
    activation="swiglu", param_dtype=torch.bfloat16,
    attn_chunk=1024,  # head_dim-TP: scores replicate over model; chunking is load-bearing
)
FAMILY = "lm"

"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H(kv=4) MoE 128e top-8 d_ff=768."""
import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen3-moe-30b-a3b",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, moe_d_ff=768, vocab=151_936,
    moe_every=1, n_experts=128, top_k=8,
    activation="swiglu", param_dtype=torch.bfloat16,
)
FAMILY = "lm"

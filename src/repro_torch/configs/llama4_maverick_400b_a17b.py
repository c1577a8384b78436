"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-*]: 48L d=5120 40H(kv=8),
interleaved MoE (every 2nd layer) 128e top-1 + 1 shared expert, d_ff=8192."""
import torch

from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, moe_d_ff=8192, vocab=202_048,
    moe_every=2, n_experts=128, top_k=1, n_shared_experts=1,
    activation="swiglu", param_dtype=torch.bfloat16,
    attn_chunk=1024,  # head_dim-TP: scores replicate over model; chunking is load-bearing
)
FAMILY = "lm"

"""LM-family shapes and the reduced config.

Counterpart of ``repro.configs.lm_family``: the same ``LM_SHAPES``
(train_4k / prefill_32k / decode_32k / long_500k) and
``reduced_lm_config``. The parameter and optimizer sharding specs
(``lm_param_specs``, ``lm_opt_specs``) and the cells (``make_lm_cell``)
wait for the dry run and the model cells with the other families' (ROADMAP
A10.4).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import LMConfig

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def reduced_lm_config(cfg: LMConfig) -> LMConfig:
    """Same family, smoke-testable on one CPU core."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_head=16,
        d_ff=128,
        moe_d_ff=64 if cfg.is_moe else 0,
        n_experts=4 if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        vocab=256,
        param_dtype=torch.float32,
        # drop-free routing so decode == forward exactly in equivalence tests
        capacity_factor=8.0,
    )

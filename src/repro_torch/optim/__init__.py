"""Optimizer of the port: AdamW with f32 state and global-norm clipping,
the same math as ``repro.optim.adamw``. ``optim/compress.py`` waits
(ROADMAP A10.4)."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm_clip,
)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm_clip"]

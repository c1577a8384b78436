"""Optimizer of the port: AdamW with f32 state and global-norm clipping,
the same math as ``repro.optim.adamw``, and int8 error-feedback gradient
compression (``optim/compress.py``)."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm_clip,
)
from repro_torch.optim.compress import (
    compress_int8,
    decompress_int8,
    ef_compress_update,
    init_residuals,
)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm_clip",
           "compress_int8", "decompress_int8", "ef_compress_update",
           "init_residuals"]

"""Example 3 on the port: train a ~100M-parameter LM end to end.

The PyTorch counterpart of ``examples/train_lm_e2e.py``: the same qwen3 MoE
*family* config at ~100M scale (8 experts, top-2, 8 layers, float32), the
same flags, learning rate, weight decay and checkpoint cadence, through
the port's substrate: ``lm_batch`` (a fresh seeded batch each step),
``train_step`` (``lm_loss``'s gradients, each layer recomputed in the
backward, then AdamW), and ``CheckpointManager`` every ``--ckpt-every``
steps (100, the reference's cadence). On the card the MoE combine and the
gradients of the embedding lookup and the dispatch run in the
``segment_reduce`` kernel.

    PYTHONPATH=src python examples/torch_train_lm_e2e.py --steps 30
    PYTHONPATH=src python examples/torch_train_lm_e2e.py --steps 2 \\
        --batch 2 --seq 32 --device cpu
"""

import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.data import DataCursor, lm_batch
from repro_torch.launch.train import train_step
from repro_torch.models.transformer import LMConfig, init_lm_params, lm_loss
from repro_torch.optim import adamw_init
from repro_torch.runtime import CheckpointManager
from repro_torch.tree import tree_leaves

CONFIG = LMConfig(
    name="qwen3-family-100m",
    n_layers=8, d_model=512, n_heads=8, n_kv_heads=4, d_head=64,
    d_ff=1408, moe_d_ff=704, vocab=32_000,
    moe_every=1, n_experts=8, top_k=2,
    param_dtype=torch.float32,
)


def main(argv=None) -> dict:
    """Trains ``--steps`` steps; returns the losses and the final params,
    optimizer state and data cursor."""
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_lm_e2e"))
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs an NVIDIA GPU; pass --device "
                         "cpu to run the plain versions on the CPU")

    cfg = CONFIG
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_lm_params(gen, cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"[e2e] {cfg.name}: {n_params / 1e6:.1f}M params on {device}")

    opt = adamw_init(params)
    ckpt = CheckpointManager(args.ckpt_dir, device=device)

    def loss_fn(prm, b):
        return lm_loss(cfg, prm, b["tokens"], b["labels"])

    cursor = DataCursor(seed=0, step=0)
    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        batch = lm_batch(cursor, args.batch, args.seq, cfg.vocab,
                         device=device)
        cursor.step += 1
        params, opt, loss, gnorm = train_step(loss_fn, params, opt, batch,
                                              lr=3e-4, weight_decay=0.01)
        losses.append(float(loss))
        if (i + 1) % 50 == 0 or i == 0:
            print(f"[e2e] step {i + 1:4d} loss {losses[-1]:.4f} "
                  f"gnorm {float(gnorm):.2f} "
                  f"({(time.perf_counter() - t0) / (i + 1) * 1e3:.0f} "
                  f"ms/step)")
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt, "cursor": cursor})
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"[e2e] a loss is not finite: {losses}")
    print(f"[e2e] loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
          f"{args.steps} steps")
    return dict(losses=losses, params=params, opt=opt, cursor=cursor)


if __name__ == "__main__":
    main()

"""End-to-end training driver of the port (``--arch <id>``): the GNN and
recsys families.

Counterpart of ``repro.launch.train`` with the same flags, plus
``--device`` (default ``cuda``; the CPU only when asked). It builds a
(possibly reduced) config, synthesizes data deterministically on the
device, and runs ``train_step`` — forward, backward, ``adamw_update`` —
with checkpoint/restart. On CUDA every GNN aggregation and every row
gather's backward runs in the ``segment_reduce`` kernel, and DIEN's pooled
history in the ``embedding_bag`` kernel. LM training waits for ROADMAP A10.3
(the LM family serves through ``launch/serve.py --arch``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch pna --steps 5 \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch dien --reduced \\
        --device cpu

``configs.gnn_family.shape_batch`` gives the batches of the named GNN
shapes (ogb_products, molecule, full_graph_sm, and minibatch_lg's sampled
subgraphs) for ``train_step``, and ``shape_run`` sets up a full-width run
on one of them; ``dien_run`` does
the same for DIEN's shapes (``configs.recsys_family``). This driver, like
the reference's, trains a GNN on one small random graph and DIEN on one
``--batch``-row batch.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_arch, recsys_family, reduced_config
from repro_torch.configs.gnn_family import _arch_shape_cfg, shape_batch
from repro_torch.data import DataCursor, dien_batch, gnn_full_batch
from repro_torch.models.dien import dien_loss, init_dien_params
from repro_torch.models.gnn import gnn_loss, init_gnn_params
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.tree import tree_leaves, tree_unflatten

# The full-width runs of each architecture on named shapes, with their
# learning rates: (architecture, shape, lr). The two deep models take 1e-4,
# since at 1e-3 their first Adam steps overshoot and a 5-step run's loss
# need not fall (the same on the card and on the CPU from the same weights).
# So does pna on minibatch_lg: a sampled subgraph's last hop has no
# in-edge, its attenuation scaler (delta / 1e-6) makes logits in the
# thousands, and at 1e-3 the loss of its step-0 subgraph went 4,301 ->
# 6,769 -> 5,913 -> 6,318 -> 5,178 on an H100, falling at 3e-4 and 1e-4.
SHAPE_RUNS = (("gcn-cora", "ogb_products", 1e-3), ("pna", "molecule", 1e-3),
              ("meshgraphnet", "full_graph_sm", 1e-4),
              ("graphcast", "full_graph_sm", 1e-4),
              ("gcn-cora", "minibatch_lg", 1e-3), ("pna", "minibatch_lg", 1e-4),
              ("meshgraphnet", "minibatch_lg", 1e-4),
              ("graphcast", "minibatch_lg", 1e-4))
# DIEN's full-width training rows on one card: train_batch's 65,536-row
# global batch (sharded over a pod by the reference) cut to a quarter,
# since the GRU and AUGRU keep ~100 steps of activations per row for the
# backward.
DIEN_TRAIN_BATCH = 16_384


def build(arch: str, reduced: bool, batch: int, seq: int,
          device: str | torch.device = "cuda"):
    """(cfg, family, params_init(gen), loss_fn(params, batch),
    data_fn(cursor)) for a GNN or recsys architecture; ``batch`` sizes the
    recsys batch, ``seq`` waits for LM training."""
    cfg, family = reduced_config(arch) if reduced else get_arch(arch)
    if family == "lm":
        raise NotImplementedError(
            f"--arch {arch}: LM training (lm_loss gradients, AdamW over "
            "bfloat16 parameters, lm_batch) is not ported yet "
            "(ROADMAP A10.3); the LM family serves through launch/serve.py "
            "--arch")
    if family == "recsys":
        def dien_init(gen):
            return init_dien_params(gen, cfg)

        def dien_loss_fn(p, b):
            return dien_loss(cfg, p, b)

        def dien_data(cursor):
            return dien_batch(cursor, batch, cfg.seq_len, cfg.n_items,
                              cfg.n_cats, device=device)
        return cfg, family, dien_init, dien_loss_fn, dien_data
    n, e = 64, 256
    cfg = dataclasses.replace(
        cfg, d_in=16, d_out=4,
        task="node_class" if cfg.arch in ("gcn", "pna") else "node_reg",
        n_vars=8 if cfg.arch == "graphcast" else cfg.n_vars)
    if cfg.arch == "graphcast":
        cfg = dataclasses.replace(cfg, d_in=8, d_out=8, task="node_reg")

    def params_init(gen):
        return init_gnn_params(gen, cfg)

    def loss_fn(p, b):
        return gnn_loss(cfg, p, b)

    def data_fn(cursor):
        b = gnn_full_batch(cursor, n, e, cfg.d_in, cfg.d_out, cfg.task,
                           device=device)
        if cfg.arch == "graphcast":
            b = _graphcastify(b, n, e, cfg, cursor, device)
        return b
    return cfg, family, params_init, loss_fn, data_fn


def _graphcastify(b, n, e, cfg, cursor, device):
    gen = cursor.generator(device, stream=1)
    m = max(n // 4, 8)
    em = 4 * m

    def ids(high, count):
        return torch.randint(0, high, (count,), generator=gen,
                             device=gen.device, dtype=torch.int32)

    return {
        "x": b["x"],
        "targets": torch.randn((n, cfg.n_vars), generator=gen,
                               device=gen.device),
        "mesh_valid": torch.ones((m,), dtype=torch.bool, device=gen.device),
        "g2m_src": b["src"], "g2m_dst": ids(m, e),
        "g2m_feat": b["edge_feat"],
        "mesh_src": ids(m, em),
        "mesh_dst": ids(m, em),
        "mesh_feat": torch.randn((em, cfg.d_edge), generator=gen,
                                 device=gen.device),
        "m2g_src": ids(m, e),
        "m2g_dst": b["dst"], "m2g_feat": b["edge_feat"],
    }


def shape_run(arch: str, shape_id: str, device: str | torch.device = "cuda",
              seed: int = 0):
    """(cfg, batch, params, opt, loss_fn, batch_at) of ``arch`` at its full
    width on ``shape_id``: ``batch_at(step)`` is the batch of
    ``DataCursor(seed, step)`` (a fresh sampled subgraph per step on a
    ``minibatch`` shape), ``batch`` is ``batch_at(0)``, the parameters come
    from a generator on ``device`` seeded with ``seed``."""
    cfg = _arch_shape_cfg(get_arch(arch)[0], shape_id)

    def batch_at(step):
        return shape_batch(cfg, shape_id, DataCursor(seed, step), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_gnn_params(gen, cfg)

    def loss_fn(p, b):
        return gnn_loss(cfg, p, b)
    return cfg, batch_at(0), params, adamw_init(params), loss_fn, batch_at


def dien_run(shape_id: str, device: str | torch.device = "cuda",
             seed: int = 0):
    """(cfg, batch, params, opt, loss_fn) of DIEN at its full width on
    ``shape_id`` (``recsys_family.RECSYS_SHAPES``; train_batch at
    ``DIEN_TRAIN_BATCH`` rows): the batch from ``DataCursor(seed, 0)``, the
    parameters from a generator on ``device`` seeded with ``seed``.
    ``loss_fn`` needs a training shape's labels."""
    cfg = get_arch("dien")[0]
    rows = DIEN_TRAIN_BATCH if shape_id == "train_batch" else None
    data = recsys_family.shape_batch(cfg, shape_id, DataCursor(seed, 0),
                                     device, rows)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = init_dien_params(gen, cfg)

    def loss_fn(p, b):
        return dien_loss(cfg, p, b)
    return cfg, data, params, adamw_init(params), loss_fn


def train_step(loss_fn, params, opt, batch, *, lr: float,
               weight_decay: float = 0.0):
    """One step: loss and gradients of ``loss_fn(params, batch)``, then
    ``adamw_update``. Returns ``(params, opt, loss, grad_norm)``; the new
    parameters are plain tensors (no autograd history)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        new_p, new_o, gnorm = adamw_update(
            tree_unflatten(params, grads), opt, params, lr=lr,
            weight_decay=weight_decay)
    return new_p, new_o, loss.detach(), gnorm


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda needs an NVIDIA GPU; pass --device "
                         "cpu to run the plain versions on the CPU")

    cfg, family, params_init, loss_fn, data_fn = build(
        args.arch, args.reduced, args.batch, args.seq, device)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    params = params_init(gen)
    opt = adamw_init(params)
    cursor = DataCursor(seed=args.seed, step=0)
    ckpt = (CheckpointManager(args.ckpt_dir, device=device)
            if args.ckpt_dir else None)
    if ckpt and args.resume:
        restored = ckpt.restore_latest()
        if restored is not None:
            params, opt, cursor = (restored["params"], restored["opt"],
                                   restored["cursor"])
            print(f"[train] resumed at step {cursor.step}")

    losses = []
    t0 = time.perf_counter()
    # Synthetic labels are random: train on the step-0 batch (memorization)
    # so the loss-decrease sanity check below is meaningful. The cursor still
    # advances (and checkpoints) exactly as a fresh-data run would.
    fixed_batch = data_fn(DataCursor(args.seed, 0))
    for i in range(cursor.step, args.steps):
        params, opt, loss, gnorm = train_step(loss_fn, params, opt,
                                              fixed_batch, lr=args.lr)
        losses.append(float(loss))
        cursor.step = i + 1
        if ckpt and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt, "cursor": cursor})
        print(f"[train] {args.arch} step {i + 1} loss {float(loss):.4f} "
              f"gnorm {float(gnorm):.3f}")
    dt = time.perf_counter() - t0
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f} "
          f"({dt:.1f}s, {dt / max(len(losses), 1) * 1e3:.1f} ms/step)")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss must decrease over the run")
    return losses


if __name__ == "__main__":
    main()

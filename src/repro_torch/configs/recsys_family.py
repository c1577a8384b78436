"""Recsys (DIEN) cells: train_batch / serve_p99 / serve_bulk / retrieval_cand.

Counterpart of ``repro.configs.recsys_family``: the same shapes, the
reference's sharding plan (the item table row-split over ``model``, the
request batch over (pod, data), the retrieval candidates over (data,
model)), its cells (``make_recsys_cell``), whose arguments are meta
tensors (``_abstract_batch``), and the reduced config. ``shape_batch`` is
their concrete counterpart: a batch with the same keys, shapes and
dtypes, built on a device.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import Cell, MeshAxes, P, meta_tensor
from repro_torch.data.pipeline import DataCursor, dien_batch
from repro_torch.models.dien import (
    DIENConfig,
    dien_forward,
    dien_loss,
    dien_score_candidates,
    init_dien_params,
)
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import tree_map

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

# The retrieval candidates pad to a multiple of 512, as the reference pads
# them for its 512-way sharding; pad candidates' scores are discarded.
CANDIDATE_PAD = 512


def dien_param_specs(cfg: DIENConfig, params, ax: MeshAxes):
    """Replicated, but the 2^23-row item table row-split over ``model``."""
    specs = tree_map(lambda a: P(*((None,) * a.dim())), params)
    specs["item_emb"] = P(ax.model, None)
    specs["cat_emb"] = P(None, None)
    return specs


def _batch_specs(ax: MeshAxes):
    bd = ax.batch
    return {
        "hist_items": P(bd, None), "hist_cats": P(bd, None),
        "hist_mask": P(bd, None),
        "target_item": P(bd), "target_cat": P(bd),
        "label": P(bd),
    }


def _abstract_batch(cfg: DIENConfig, b: int, with_label: bool = True):
    """A ``b``-row batch of meta tensors: ``shape_batch``'s keys, shapes
    and dtypes."""
    i32 = torch.int32
    d = {
        "hist_items": meta_tensor((b, cfg.seq_len), i32),
        "hist_cats": meta_tensor((b, cfg.seq_len), i32),
        "hist_mask": meta_tensor((b, cfg.seq_len), torch.bool),
        "target_item": meta_tensor((b,), i32),
        "target_cat": meta_tensor((b,), i32),
    }
    if with_label:
        d["label"] = meta_tensor((b,), i32)
    return d


def make_recsys_cell(cfg: DIENConfig, shape_id: str, mesh) -> Cell:
    """The ``<cfg.name>/<shape_id>`` cell on ``mesh``:

    * train: ``fn(params, opt, batch)`` -> ``(params, opt, {"loss",
      "grad_norm"})``, one ``launch.train.train_step`` (lr 1e-3, no weight
      decay, as the reference's);
    * serve: ``fn(params, batch)`` -> logits [B, 2] (``dien_forward``);
    * retrieval: ``fn(params, batch)`` -> scores [C] over the candidates,
      padded to ``CANDIDATE_PAD`` (``dien_score_candidates``).

    Serving and retrieval run without autograd.
    """
    ax = MeshAxes.for_mesh(mesh)
    sh = RECSYS_SHAPES[shape_id]
    params = init_dien_params(None, cfg, device="meta")
    pspecs = dien_param_specs(cfg, params, ax)
    name = f"{cfg.name}/{shape_id}"

    if sh["kind"] == "train":
        from repro_torch.launch.train import train_step
        ospecs = AdamWState(m=pspecs, v=pspecs, count=P())

        def loss_fn(p, batch):
            return dien_loss(cfg, p, batch)

        def dien_train_step(params, opt_state, batch):
            new_p, new_o, loss, gnorm = train_step(
                loss_fn, params, opt_state, batch, lr=1e-3)
            return new_p, new_o, {"loss": loss, "grad_norm": gnorm}

        return Cell(name, dien_train_step,
                    (params, adamw_init(params),
                     _abstract_batch(cfg, sh["batch"])),
                    in_specs=(pspecs, ospecs, _batch_specs(ax)),
                    out_specs=(pspecs, ospecs,
                               {"loss": P(), "grad_norm": P()}),
                    donate=(0, 1))

    if sh["kind"] == "serve":
        bspecs = {k: v for k, v in _batch_specs(ax).items() if k != "label"}

        def serve_step(params, batch):
            with torch.no_grad():
                return dien_forward(cfg, params, batch)[0]

        return Cell(name, serve_step,
                    (params, _abstract_batch(cfg, sh["batch"], False)),
                    in_specs=(pspecs, bspecs), out_specs=P(ax.batch, None))

    # retrieval: 1 user x the candidates, padded to the 512-way split (the
    # pad candidates' scores are discarded by the caller)
    c = -(-sh["n_candidates"] // CANDIDATE_PAD) * CANDIDATE_PAD
    batch = _abstract_batch(cfg, 1, with_label=False)
    batch["cand_items"] = meta_tensor((c,), torch.int32)
    batch["cand_cats"] = meta_tensor((c,), torch.int32)
    bspecs = {k: P(None, None) if v.dim() == 2 else P(None)
              for k, v in batch.items()
              if k.startswith("hist") or k.startswith("target")}
    bspecs["cand_items"] = P((ax.fsdp, ax.model))
    bspecs["cand_cats"] = P((ax.fsdp, ax.model))

    def retrieval_step(params, batch):
        with torch.no_grad():
            return dien_score_candidates(cfg, params, batch)

    return Cell(name, retrieval_step, (params, batch),
                in_specs=(pspecs, bspecs), out_specs=P((ax.fsdp, ax.model)))


def shape_batch(cfg: DIENConfig, shape_id: str, cursor: DataCursor,
                device: str | torch.device = "cuda",
                batch: int | None = None) -> dict:
    """One batch of ``shape_id`` on ``device`` from ``cursor``'s generator:
    ``dien_batch``'s keys (with ``label`` for training only) and, for
    retrieval, one user's history and ``cand_items``/``cand_cats`` padded
    to ``CANDIDATE_PAD``. ``batch`` overrides the shape's row count."""
    sh = RECSYS_SHAPES[shape_id]
    rows = sh["batch"] if batch is None else batch
    out = dien_batch(cursor, rows, cfg.seq_len, cfg.n_items, cfg.n_cats,
                     device=device)
    if sh["kind"] == "train":
        return out
    del out["label"]
    if sh["kind"] == "retrieval":
        c = -(-sh["n_candidates"] // CANDIDATE_PAD) * CANDIDATE_PAD
        gen = cursor.generator(device, stream=1)   # apart from the history's
        for key, high in (("cand_items", cfg.n_items),
                          ("cand_cats", cfg.n_cats)):
            out[key] = torch.randint(0, high, (c,), generator=gen,
                                     device=gen.device, dtype=torch.int32)
    return out


def reduced_recsys_config(cfg: DIENConfig) -> DIENConfig:
    return dataclasses.replace(cfg, n_items=1_000, n_cats=50, seq_len=10)

"""Recsys (DIEN) shapes: train_batch / serve_p99 / serve_bulk / retrieval_cand.

Counterpart of ``repro.configs.recsys_family``: the same shapes and the
reduced config. ``shape_batch`` is the concrete counterpart of the
reference's abstract ``_abstract_batch``: a batch with the same keys,
shapes and dtypes, built on a device. The mesh, sharding and ``Cell``
parts wait for the dry run and model cells (ROADMAP A10.4).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.data.pipeline import DataCursor, dien_batch
from repro_torch.models.dien import DIENConfig

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

# The retrieval candidates pad to a multiple of 512, as the reference pads
# them for its 512-way sharding; pad candidates' scores are discarded.
CANDIDATE_PAD = 512


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

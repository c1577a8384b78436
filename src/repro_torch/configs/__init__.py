"""Architecture registry of the port: ``--arch <id>`` resolution.

All ten architectures resolve: the LM family (qwen3-moe-30b-a3b,
llama4-maverick-400b-a17b, llama3.2-3b, nemotron-4-340b, stablelm-1.6b),
the GNN family (gcn-cora, pna, meshgraphnet, graphcast) and the recsys
family (dien). Each has its family's shapes (``shapes_for``) and a cell
per shape (``make_cell``): 40 (arch x shape) cells in all.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import Cell

ARCH_IDS = [
    "qwen3-moe-30b-a3b",
    "llama4-maverick-400b-a17b",
    "llama3.2-3b",
    "nemotron-4-340b",
    "stablelm-1.6b",
    "pna",
    "graphcast",
    "gcn-cora",
    "meshgraphnet",
    "dien",
]

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "llama3.2-3b": "llama3_2_3b",
    "nemotron-4-340b": "nemotron_4_340b",
    "stablelm-1.6b": "stablelm_1_6b",
    "pna": "pna",
    "graphcast": "graphcast",
    "gcn-cora": "gcn_cora",
    "meshgraphnet": "meshgraphnet",
    "dien": "dien",
}


def get_arch(arch_id: str):
    """Returns (config, family) for an architecture id."""
    if arch_id not in _MODULES:
        raise KeyError(f"unknown architecture {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG, mod.FAMILY


def shapes_for(arch_id: str) -> list[str]:
    _, family = get_arch(arch_id)
    if family == "lm":
        from repro_torch.configs.lm_family import LM_SHAPES
        return list(LM_SHAPES)
    if family == "gnn":
        from repro_torch.configs.gnn_family import GNN_SHAPES
        return list(GNN_SHAPES)
    if family == "recsys":
        from repro_torch.configs.recsys_family import RECSYS_SHAPES
        return list(RECSYS_SHAPES)
    raise ValueError(family)


def make_cell(arch_id: str, shape_id: str, mesh) -> Cell:
    """The (arch x shape) cell on ``mesh`` (its arguments on meta)."""
    cfg, family = get_arch(arch_id)
    if family == "lm":
        from repro_torch.configs.lm_family import make_lm_cell
        return make_lm_cell(cfg, shape_id, mesh)
    if family == "gnn":
        from repro_torch.configs.gnn_family import make_gnn_cell
        return make_gnn_cell(cfg, shape_id, mesh)
    if family == "recsys":
        from repro_torch.configs.recsys_family import make_recsys_cell
        return make_recsys_cell(cfg, shape_id, mesh)
    raise ValueError(family)


def all_cells(mesh) -> list[tuple[str, str]]:
    """Every (arch, shape) pair; the cells are the same set on any mesh."""
    return [(a, s) for a in ARCH_IDS for s in shapes_for(a)]


def reduced_config(arch_id: str):
    """(reduced config, family): LMs at 2 layers, width 64, vocab 256,
    float32; GNNs at 2 layers, width 16 (8 graphcast vars); DIEN at 1,000
    items, 50 categories, sequence 10."""
    cfg, family = get_arch(arch_id)
    if family == "lm":
        from repro_torch.configs.lm_family import reduced_lm_config
        return reduced_lm_config(cfg), family
    if family == "recsys":
        from repro_torch.configs.recsys_family import reduced_recsys_config
        return reduced_recsys_config(cfg), family
    from repro_torch.configs.gnn_family import reduced_gnn_config
    return reduced_gnn_config(cfg), family

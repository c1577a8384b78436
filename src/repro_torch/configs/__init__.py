"""Architecture registry of the port: ``--arch <id>`` resolution.

The GNN family (gcn-cora, pna, meshgraphnet, graphcast) and the recsys
family (dien) are ported; the LM architectures raise
``NotImplementedError`` naming the ROADMAP item they wait for.
"""

from __future__ import annotations

import importlib

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
    "pna": "pna",
    "graphcast": "graphcast",
    "gcn-cora": "gcn_cora",
    "meshgraphnet": "meshgraphnet",
    "dien": "dien",
}


def get_arch(arch_id: str):
    """Returns (config, family) for an architecture id."""
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in _MODULES:
        raise NotImplementedError(f"{arch_id} is not ported yet: it waits "
                                  "for the LM slice (ROADMAP A10.3, LM family)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG, mod.FAMILY


def reduced_config(arch_id: str):
    """(reduced config, family): GNNs at 2 layers, width 16 (8 graphcast
    vars); DIEN at 1,000 items, 50 categories, sequence 10."""
    cfg, family = get_arch(arch_id)
    if family == "recsys":
        from repro_torch.configs.recsys_family import reduced_recsys_config
        return reduced_recsys_config(cfg), family
    from repro_torch.configs.gnn_family import reduced_gnn_config
    return reduced_gnn_config(cfg), family

"""Architecture registry of the port: ``--arch <id>`` resolution.

The GNN family (gcn-cora, pna, meshgraphnet, graphcast) is ported; the LM
and recsys architectures raise ``NotImplementedError`` naming the ROADMAP
item they wait for.
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
}

_WAITING = {
    "dien": "the recsys slice (ROADMAP §A12: models/embedding.py, the "
            "embedding_bag kernel B4, then models/dien.py)",
}


def get_arch(arch_id: str):
    """Returns (config, family) for an architecture id."""
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown architecture {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in _MODULES:
        waits = _WAITING.get(arch_id, "the LM slice (ROADMAP §A12, LM family)")
        raise NotImplementedError(f"{arch_id} is not ported yet: it waits "
                                  f"for {waits}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG, mod.FAMILY


def reduced_config(arch_id: str):
    """(reduced config, family): 2 layers, width 16 (8 graphcast vars)."""
    cfg, family = get_arch(arch_id)
    from repro_torch.configs.gnn_family import reduced_gnn_config
    return reduced_gnn_config(cfg), family

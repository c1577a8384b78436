"""GNN-family cells: full_graph_sm / minibatch_lg / ogb_products / molecule.

Counterpart of ``repro.configs.gnn_family``: the same shapes, padding and
per-shape binding of the feature dims, the reference's sharding plan
(edge arrays over every mesh axis, node arrays over (data, model), the
MLP parameters replicated, the minibatch feature table row-split) and its
cells (``make_gnn_cell``), whose arguments are meta tensors
(``_graph_input_specs``). ``shape_batch`` is their concrete counterpart:
a batch with the same keys, shapes, dtypes and padding, built on a
device. The ``minibatch`` kind samples a subgraph of the shape's graph
(``shape_graph``: a seeded uniform graph at the shape's node and edge
counts, built once per process) with the port's ``graph/sampler.py``.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.base import Cell, MeshAxes, P, meta_tensor
from repro_torch.data.pipeline import (
    DataCursor,
    gnn_full_batch,
    gnn_molecule_batch,
    gnn_sampled_batch,
    uniform_graph,
)
from repro_torch.graph.sampler import NeighborSampler, subgraph_shapes
from repro_torch.models.gnn import GNNConfig, gnn_loss, init_gnn_params
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWState
from repro_torch.tree import tree_map

GNN_SHAPES = {
    "full_graph_sm": dict(kind="full", n_nodes=2_708, n_edges=10_556, d_feat=1_433),
    "minibatch_lg": dict(kind="minibatch", n_nodes=232_965, n_edges=114_615_892,
                         batch_nodes=1_024, fanout=(15, 10), d_feat=602),
    "ogb_products": dict(kind="full", n_nodes=2_449_029, n_edges=61_859_140,
                         d_feat=100),
    "molecule": dict(kind="molecule", n_nodes=30, n_edges=64, batch=128, d_feat=32),
}

# Node arrays pad to 1024 and edge arrays to 512, as the reference pads them
# for its sharded jit boundary. Padded edges carry the sentinel dst == n;
# padded labels are -1 (masked by the CE loss); padded nodes of a molecule
# batch carry the sentinel graph id n_graphs; padded nodes of a sampled
# batch carry id 0 and node_valid False.
NODE_PAD, EDGE_PAD = 1024, 512


def _pad(n: int, g: int) -> int:
    return ((n + g - 1) // g) * g


def _arch_shape_cfg(cfg: GNNConfig, shape_id: str) -> GNNConfig:
    """Bind the generic shape's feature dims into the arch config."""
    sh = GNN_SHAPES[shape_id]
    d_in = cfg.n_vars if cfg.arch == "graphcast" else sh["d_feat"]
    d_out = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47,
             "molecule": 1}[shape_id]
    task = cfg.task
    if cfg.arch == "graphcast":
        d_out, task = cfg.n_vars, "node_reg"
    elif shape_id == "molecule":
        task = "graph_reg"
    feature_table = (_pad(sh["n_nodes"], NODE_PAD)
                     if sh["kind"] == "minibatch" else 0)
    return dataclasses.replace(cfg, d_in=d_in, d_out=d_out, task=task,
                               feature_table=feature_table)


def _graph_input_specs(cfg: GNNConfig, shape_id: str, ax: MeshAxes):
    """(batch of meta tensors, batch specs) of one shape cell, the
    reference's: ``shape_batch``'s keys, shapes and dtypes."""
    sh = GNN_SHAPES[shape_id]
    all_axes = ax.batch + (ax.model,)
    node_p = P((ax.fsdp, ax.model))
    edge_p = P(all_axes)
    f32, i32 = torch.float32, torch.int32
    S = meta_tensor

    if sh["kind"] == "minibatch":
        n_local, n_edges = subgraph_shapes(sh["batch_nodes"], sh["fanout"])
        n_local, n_edges = _pad(n_local, NODE_PAD), _pad(n_edges, EDGE_PAD)
        batch = {
            "nodes": S((n_local,), i32),
            "node_valid": S((n_local,), torch.bool),
            "src": S((n_edges,), i32),
            "dst": S((n_edges,), i32),
            "edge_feat": S((n_edges, cfg.d_edge), f32),
            "n_seeds": S((), i32),
        }
        specs = {
            "nodes": node_p, "node_valid": node_p,
            "src": edge_p, "dst": edge_p, "edge_feat": P(all_axes, None),
            "n_seeds": P(),
        }
        if cfg.task == "node_class":
            batch["labels"] = S((sh["batch_nodes"],), i32)
            specs["labels"] = P((ax.fsdp,))
        else:
            batch["targets"] = S((sh["batch_nodes"], cfg.d_out), f32)
            specs["targets"] = P((ax.fsdp,), None)
        n_nodes_model = n_local
    elif sh["kind"] == "molecule":
        n = _pad(sh["batch"] * sh["n_nodes"], NODE_PAD)
        e = _pad(sh["batch"] * sh["n_edges"], EDGE_PAD)
        batch = {
            "x": S((n, cfg.d_in), f32),
            "src": S((e,), i32), "dst": S((e,), i32),
            "edge_feat": S((e, cfg.d_edge), f32),
            "graph_id": S((n,), i32),
            "graph_targets": S((sh["batch"], cfg.d_out), f32),
        }
        specs = {
            "x": P((ax.fsdp, ax.model), None),
            "src": edge_p, "dst": edge_p, "edge_feat": P(all_axes, None),
            "graph_id": node_p,
            "graph_targets": P((ax.fsdp,), None),
        }
        n_nodes_model = n
    else:  # full graph
        n, e = _pad(sh["n_nodes"], NODE_PAD), _pad(sh["n_edges"], EDGE_PAD)
        batch = {
            "x": S((n, cfg.d_in), f32),
            "src": S((e,), i32), "dst": S((e,), i32),
            "edge_feat": S((e, cfg.d_edge), f32),
        }
        specs = {
            "x": P((ax.fsdp, ax.model), None),
            "src": edge_p, "dst": edge_p, "edge_feat": P(all_axes, None),
        }
        if cfg.task == "node_class":
            batch["labels"] = S((n,), i32)
            specs["labels"] = node_p
        else:
            batch["targets"] = S((n, cfg.d_out), f32)
            specs["targets"] = P((ax.fsdp, ax.model), None)
        n_nodes_model = n

    if cfg.arch == "graphcast":
        # the derived mesh graph: the grid is the shape's graph
        m = max(n_nodes_model // 4, 42)
        em = 4 * m
        e_g2m = batch["src"].shape[0]
        batch.update({
            "mesh_valid": S((m,), torch.bool),
            "g2m_src": batch.pop("src"), "g2m_dst": batch.pop("dst"),
            "g2m_feat": batch.pop("edge_feat"),
            "mesh_src": S((em,), i32), "mesh_dst": S((em,), i32),
            "mesh_feat": S((em, cfg.d_edge), f32),
            "m2g_src": S((e_g2m,), i32), "m2g_dst": S((e_g2m,), i32),
            "m2g_feat": S((e_g2m, cfg.d_edge), f32),
        })
        specs.update({
            "mesh_valid": node_p,
            "g2m_src": specs.pop("src"), "g2m_dst": specs.pop("dst"),
            "g2m_feat": specs.pop("edge_feat"),
            "mesh_src": edge_p, "mesh_dst": edge_p,
            "mesh_feat": P(all_axes, None),
            "m2g_src": edge_p, "m2g_dst": edge_p,
            "m2g_feat": P(all_axes, None),
        })
        # graphcast regresses grid vars; retarget shape-specific labels
        for k in ("labels", "targets"):
            batch.pop(k, None)
            specs.pop(k, None)
        batch["targets"] = S((n_nodes_model, cfg.n_vars), f32)
        specs["targets"] = P((ax.fsdp, ax.model), None)
    return batch, specs


def gnn_param_specs(cfg: GNNConfig, params, ax: MeshAxes):
    """MLP parameters replicated; the feature table, where there is one,
    row-split over (data, model)."""
    specs = tree_map(lambda a: P(*((None,) * a.dim())), params)
    if cfg.feature_table:
        specs["features"] = P((ax.fsdp, ax.model), None)
    return specs


def make_gnn_cell(cfg: GNNConfig, shape_id: str, mesh) -> Cell:
    """The ``<cfg.name>/<shape_id>`` training cell on ``mesh``:
    ``fn(params, opt, batch)`` -> ``(params, opt, {"loss",
    "grad_norm"})``, one ``launch.train.train_step`` (lr 1e-3, no weight
    decay, as the reference's), on the shape-bound config."""
    from repro_torch.launch.train import train_step
    ax = MeshAxes.for_mesh(mesh)
    cfg = _arch_shape_cfg(cfg, shape_id)
    batch, bspecs = _graph_input_specs(cfg, shape_id, ax)
    params = init_gnn_params(None, cfg, device="meta")
    opt = adamw_init(params)
    pspecs = gnn_param_specs(cfg, params, ax)
    ospecs = AdamWState(m=pspecs, v=pspecs, count=P())

    def loss_fn(p, batch):
        return gnn_loss(cfg, p, batch)

    def gnn_train_step(params, opt_state, batch):
        new_p, new_o, loss, gnorm = train_step(loss_fn, params, opt_state,
                                               batch, lr=1e-3)
        return new_p, new_o, {"loss": loss, "grad_norm": gnorm}

    return Cell(
        name=f"{cfg.name}/{shape_id}", fn=gnn_train_step,
        args=(params, opt, batch),
        in_specs=(pspecs, ospecs, bspecs),
        out_specs=(pspecs, ospecs, {"loss": P(), "grad_norm": P()}),
        donate=(0, 1))


def _pad_rows(t: torch.Tensor, rows: int, value) -> torch.Tensor:
    """``t`` grown along its first axis to ``rows`` with ``value``."""
    extra = torch.full((rows - t.shape[0],) + tuple(t.shape[1:]), value,
                       dtype=t.dtype, device=t.device)
    return torch.cat([t, extra])


def _pad_edges(batch: dict, e: int, sentinel: int) -> None:
    batch["src"] = _pad_rows(batch["src"], e, 0)
    batch["dst"] = _pad_rows(batch["dst"], e, sentinel)
    batch["edge_feat"] = _pad_rows(batch["edge_feat"], e, 0.0)


@functools.lru_cache(maxsize=1)
def shape_graph(shape_id: str, seed: int) -> NeighborSampler:
    """The host graph a ``minibatch`` shape samples from: ``uniform_graph``
    at the shape's node and edge counts, built at the first call for
    ``(shape_id, seed)`` and shared by every later one (the last one only
    is kept)."""
    sh = GNN_SHAPES[shape_id]
    return uniform_graph(sh["n_nodes"], sh["n_edges"], seed)


def shape_batch(cfg: GNNConfig, shape_id: str, cursor: DataCursor,
                device: str | torch.device = "cuda",
                graph: NeighborSampler | None = None) -> dict:
    """One padded batch of ``shape_id`` for the shape-bound ``cfg`` (see
    ``_arch_shape_cfg``), on ``device``, from ``cursor``'s generators.

    A ``minibatch`` shape samples ``graph``, by default
    ``shape_graph(shape_id, cursor.seed)``: the sampler's sentinel ``dst ==
    n_local`` becomes the padded node count, the ``dst == n`` of every
    shape. GraphCast's grid
    is the shape's graph (a sampled batch's subgraph); its mesh has
    ``max(n // 4, 42)`` nodes and ``4 * mesh`` edges, with random
    grid->mesh destinations, mesh edges and mesh->grid sources, and
    grid-edge sentinels carried over to both bipartite edge sets.
    """
    sh = GNN_SHAPES[shape_id]
    if sh["kind"] == "minibatch":
        if graph is None:
            graph = shape_graph(shape_id, cursor.seed)
        batch = gnn_sampled_batch(cursor, graph,
                                  sh["batch_nodes"],
                                  sh["fanout"], cfg.d_out, cfg.task,
                                  cfg.d_edge, device=device)
        n_local = batch["nodes"].shape[0]
        n = _pad(n_local, NODE_PAD)
        e = _pad(batch["src"].shape[0], EDGE_PAD)
        batch["dst"] = torch.where(batch["dst"] == n_local, n, batch["dst"])
        batch["nodes"] = _pad_rows(batch["nodes"], n, 0)
        batch["node_valid"] = _pad_rows(batch["node_valid"], n, False)
    elif sh["kind"] == "molecule":
        n_graphs = sh["batch"]
        n = _pad(n_graphs * sh["n_nodes"], NODE_PAD)
        e = _pad(n_graphs * sh["n_edges"], EDGE_PAD)
        batch = gnn_molecule_batch(cursor, n_graphs, sh["n_nodes"],
                                   sh["n_edges"], cfg.d_in, cfg.d_out,
                                   cfg.d_edge, device=device)
        batch["x"] = _pad_rows(batch["x"], n, 0.0)
        batch["graph_id"] = _pad_rows(batch["graph_id"], n, n_graphs)
    else:
        n, e = _pad(sh["n_nodes"], NODE_PAD), _pad(sh["n_edges"], EDGE_PAD)
        batch = gnn_full_batch(cursor, sh["n_nodes"], sh["n_edges"], cfg.d_in,
                               cfg.d_out, cfg.task, cfg.d_edge, device=device)
        batch["x"] = _pad_rows(batch["x"], n, 0.0)
        if "labels" in batch:
            batch["labels"] = _pad_rows(batch["labels"], n, -1)
        else:
            batch["targets"] = _pad_rows(batch["targets"], n, 0.0)
    real_edges = batch["src"].shape[0]
    _pad_edges(batch, e, n)

    if cfg.arch == "graphcast":
        gen = cursor.generator(device, stream=1)   # apart from the graph's
        m = max(n // 4, 42)
        em = 4 * m
        pad_e = e - real_edges

        def ids(high, count):
            return torch.randint(0, high, (count,), generator=gen,
                                 device=gen.device, dtype=torch.int32)

        g2m_dst = torch.cat([ids(m, real_edges),
                             torch.full((pad_e,), m, dtype=torch.int32,
                                        device=gen.device)])
        # a sampled batch's invalid samples are sentinel edges too
        g2m_dst = torch.where(batch["dst"] == n, m, g2m_dst)
        m2g_src = _pad_rows(ids(m, real_edges), e, 0)
        batch.update({
            "mesh_valid": torch.ones((m,), dtype=torch.bool, device=gen.device),
            "g2m_src": batch.pop("src"), "g2m_dst": g2m_dst,
            "g2m_feat": batch["edge_feat"],
            "mesh_src": ids(m, em), "mesh_dst": ids(m, em),
            "mesh_feat": torch.randn((em, cfg.d_edge), generator=gen,
                                     device=gen.device),
            "m2g_src": m2g_src, "m2g_dst": batch.pop("dst"),
            "m2g_feat": batch.pop("edge_feat"),
        })
        # graphcast regresses grid vars; retarget shape-specific labels
        for k in ("labels", "targets"):
            batch.pop(k, None)
        batch["targets"] = torch.randn((n, cfg.n_vars), generator=gen,
                                       device=gen.device)
    return batch


def reduced_gnn_config(cfg: GNNConfig) -> GNNConfig:
    return dataclasses.replace(
        cfg, n_layers=min(cfg.n_layers, 2), d_hidden=16,
        n_vars=8 if cfg.arch == "graphcast" else cfg.n_vars)

"""GNN family: GCN / PNA / MeshGraphNet / GraphCast on segment-reduce message
passing.

Counterpart of ``repro.models.gnn``, with the same config, parameter keys
and batch layout. Every aggregation — the messages by dst, the degrees, the
pooling by graph id — and the backward of every row gather ``h[idx]`` runs
in the port's ``segment_reduce`` (the hand-written kernel on CUDA, its plain
version on the CPU), so the card's forward and gradients are deterministic.

Batch format: a dict of tensors. Padded edges have ``dst == n_nodes`` (the
sentinel segment, dropped). GraphCast uses its own encode (grid -> mesh),
process (mesh) and decode (mesh -> grid) edge sets.

Each forward sorts each index array once (``segment_layout``) and shares
the layout among every reduction and gather on it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels.segment_reduce import (
    gather_rows,
    segment_layout,
    segment_reduce,
)
from repro_torch.models.common import (
    mlp_apply,
    mlp_params,
    mse_loss,
    softmax_cross_entropy,
)


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    arch: str                     # "gcn" | "pna" | "meshgraphnet" | "graphcast"
    n_layers: int
    d_hidden: int
    d_in: int
    d_out: int
    task: str                     # "node_class" | "node_reg" | "graph_reg"
    aggregator: str = "sum"
    d_edge: int = 4
    mlp_layers: int = 2
    feature_table: int = 0        # >0: node features gathered from a table (sampled training)
    n_vars: int = 0               # graphcast in/out channel count


class Layouts:
    """The segment layouts of one batch's index arrays, each sorted once.

    ``layouts(ids, n)`` returns ``segment_layout(ids, n)``, computed at the
    first request for that tensor and count; a forward creates one and
    passes it down.
    """

    def __init__(self):
        self._cache = {}

    def __call__(self, ids: torch.Tensor, n: int):
        key = (id(ids), n)   # the entry keeps ids alive, so its id is unique
        if key not in self._cache:
            self._cache[key] = (ids, segment_layout(ids, n))
        return self._cache[key][1]


def _seg(op: str, data, seg, num: int, lay: Layouts):
    """``op``-reduce of ``data`` by ``seg`` into ``num`` rows (ids outside
    ``[0, num)`` dropped)."""
    layout = lay(seg, num)
    if op in ("sum", "max", "min"):
        return segment_reduce(data.contiguous(), seg, num_segments=num,
                              reduce=op, layout=layout)
    if op == "mean":
        s = segment_reduce(data.contiguous(), seg, num_segments=num,
                           layout=layout)
        ones = torch.ones((data.shape[0], 1), device=data.device)
        c = segment_reduce(ones, seg, num_segments=num, layout=layout)
        return s / torch.clamp(c, min=1.0)
    raise ValueError(op)


def _gather(h, idx, lay: Layouts):
    """``h[idx]`` with the deterministic backward."""
    return gather_rows(h, idx, lay(idx, h.shape[0]))


# ---------------------------------------------------------------------------
# GCN (Kipf & Welling) — SpMM with symmetric normalization
# ---------------------------------------------------------------------------

def init_gcn(gen: torch.Generator | None, cfg: GNNConfig, device):
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
    return {"w": [torch.randn((a, b), generator=gen, device=device)
                  / math.sqrt(a) for a, b in zip(dims[:-1], dims[1:])]}


def gcn_forward(cfg: GNNConfig, params, batch, lay: Layouts):
    x, src, dst = batch["x"], batch["src"], batch["dst"]
    n = x.shape[0]
    valid = (dst < n).float()  # padded edges must not count
    deg_in = _seg("sum", valid, dst, n, lay)
    deg_out = _seg("sum", valid, src, n, lay)
    norm = (torch.rsqrt(torch.clamp(deg_out, min=1.0))[src.long()]
            * torch.rsqrt(torch.clamp(deg_in, min=1.0))[
                torch.clamp(dst, max=n - 1).long()])
    for i, w in enumerate(params["w"]):
        h = x @ w
        msg = _gather(h, src, lay) * norm[:, None]
        x = _seg("sum", msg, dst, n, lay)
        if i < len(params["w"]) - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# PNA (Corso et al.) — multi-aggregator (mean/max/min/std) × degree scalers
# ---------------------------------------------------------------------------

PNA_AGGS = ("mean", "max", "min", "std")
PNA_SCALERS = ("identity", "amplification", "attenuation")


def init_pna(gen: torch.Generator | None, cfg: GNNConfig, device):
    d = cfg.d_hidden
    n_cat = len(PNA_AGGS) * len(PNA_SCALERS) * d + d
    layers = [{"post": mlp_params(gen, (n_cat, d, d), device=device)}
              for _ in range(cfg.n_layers)]
    return {
        "enc": mlp_params(gen, (cfg.d_in, d), device=device),
        "layers": layers,
        "dec": mlp_params(gen, (d, d, cfg.d_out), device=device),
    }


def pna_forward(cfg: GNNConfig, params, batch, lay: Layouts):
    x, src, dst = batch["x"], batch["src"], batch["dst"]
    n = x.shape[0]
    h = mlp_apply(params["enc"], x)
    ones = torch.ones((src.shape[0], 1), device=x.device)
    deg = _seg("sum", ones, dst, n, lay)[:, 0]
    logd = torch.log1p(deg)
    delta = torch.mean(logd) + 1e-6
    scalers = torch.stack([torch.ones_like(logd), logd / delta,
                           delta / torch.clamp(logd, min=1e-6)], 1)  # [N, 3]
    real = (dst < n)[:, None]
    has_deg = (deg > 0)[:, None]
    zero = torch.zeros((), device=x.device)
    for lyr in params["layers"]:
        msg = _gather(h, src, lay)
        mean = _seg("mean", msg, dst, n, lay)
        mx = _seg("max", torch.where(real, msg, -math.inf), dst, n, lay)
        mn = _seg("min", torch.where(real, msg, math.inf), dst, n, lay)
        m2 = _seg("mean", torch.square(msg), dst, n, lay)
        std = torch.sqrt(torch.relu(m2 - torch.square(mean)) + 1e-5)
        mx = torch.where(has_deg, mx, zero)
        mn = torch.where(has_deg, mn, zero)
        aggs = torch.stack([mean, mx, mn, std], 1)                # [N, 4, D]
        scaled = aggs[:, :, None, :] * scalers[:, None, :, None]  # [N, 4, 3, D]
        cat = torch.cat([h, scaled.reshape(n, -1)], -1)
        h = h + mlp_apply(lyr["post"], cat)
    return mlp_apply(params["dec"], h)


# ---------------------------------------------------------------------------
# MeshGraphNet (Pfaff et al.) — edge+node MLP blocks with residuals
# ---------------------------------------------------------------------------

def _mgn_mlp(gen, device, d_in, d_h, d_out, n_hidden=2):
    dims = (d_in,) + (d_h,) * n_hidden + (d_out,)
    return mlp_params(gen, dims, norm=True, device=device)


def init_meshgraphnet(gen: torch.Generator | None, cfg: GNNConfig, device):
    d = cfg.d_hidden
    blocks = [{"edge": _mgn_mlp(gen, device, 3 * d, d, d, cfg.mlp_layers),
               "node": _mgn_mlp(gen, device, 2 * d, d, d, cfg.mlp_layers)}
              for _ in range(cfg.n_layers)]
    return {
        "node_enc": _mgn_mlp(gen, device, cfg.d_in, d, d, cfg.mlp_layers),
        "edge_enc": _mgn_mlp(gen, device, cfg.d_edge, d, d, cfg.mlp_layers),
        "dec": mlp_params(gen, (d, d, cfg.d_out), device=device),
        "blocks": blocks,
    }


def _mgn_process(blocks, h, e, src, dst, n, aggregator, lay: Layouts):
    dst_c = torch.clamp(dst, max=n - 1)
    for blk in blocks:
        he = torch.cat([e, _gather(h, src, lay), _gather(h, dst_c, lay)], -1)
        e = e + mlp_apply(blk["edge"], he)
        agg = _seg(aggregator, e, dst, n, lay)
        h = h + mlp_apply(blk["node"], torch.cat([h, agg], -1))
    return h, e


def meshgraphnet_forward(cfg: GNNConfig, params, batch, lay: Layouts):
    x, src, dst = batch["x"], batch["src"], batch["dst"]
    n = x.shape[0]
    h = mlp_apply(params["node_enc"], x)
    e = mlp_apply(params["edge_enc"], batch["edge_feat"])
    h, _ = _mgn_process(params["blocks"], h, e, src, dst, n, cfg.aggregator,
                        lay)
    return mlp_apply(params["dec"], h)


# ---------------------------------------------------------------------------
# GraphCast (Lam et al.) — encode(grid→mesh) / process(mesh) / decode(mesh→grid)
# ---------------------------------------------------------------------------

def init_graphcast(gen: torch.Generator | None, cfg: GNNConfig, device):
    d = cfg.d_hidden
    blocks = [{"edge": _mgn_mlp(gen, device, 3 * d, d, d, 1),
               "node": _mgn_mlp(gen, device, 2 * d, d, d, 1)}
              for _ in range(cfg.n_layers)]
    return {
        "grid_enc": _mgn_mlp(gen, device, cfg.n_vars, d, d, 1),
        "g2m_edge": _mgn_mlp(gen, device, cfg.d_edge, d, d, 1),
        "mesh_edge": _mgn_mlp(gen, device, cfg.d_edge, d, d, 1),
        "mesh_up": _mgn_mlp(gen, device, d, d, d, 1),
        "blocks": blocks,
        "m2g_edge": _mgn_mlp(gen, device, cfg.d_edge, d, d, 1),
        "grid_up": _mgn_mlp(gen, device, 2 * d, d, d, 1),
        "dec": mlp_params(gen, (d, d, cfg.n_vars), device=device),
    }


def graphcast_forward(cfg: GNNConfig, params, batch, lay: Layouts):
    xg = batch["x"]                              # [N_grid, n_vars]
    n_grid = xg.shape[0]
    n_mesh = batch["mesh_valid"].shape[0]

    hg = mlp_apply(params["grid_enc"], xg)

    # encode: grid -> mesh
    e = mlp_apply(params["g2m_edge"], batch["g2m_feat"])
    msg = e + _gather(hg, batch["g2m_src"], lay)
    hm = _seg("sum", msg, batch["g2m_dst"], n_mesh, lay)
    hm = mlp_apply(params["mesh_up"], hm)

    # process on the (multi-)mesh
    em = mlp_apply(params["mesh_edge"], batch["mesh_feat"])
    hm, _ = _mgn_process(params["blocks"], hm, em, batch["mesh_src"],
                         batch["mesh_dst"], n_mesh, "sum", lay)

    # decode: mesh -> grid
    e2 = mlp_apply(params["m2g_edge"], batch["m2g_feat"])
    msg2 = e2 + _gather(hm, batch["m2g_src"], lay)
    hg2 = _seg("sum", msg2, batch["m2g_dst"], n_grid, lay)
    hg = mlp_apply(params["grid_up"], torch.cat([hg, hg2], -1))
    return mlp_apply(params["dec"], hg)


# ---------------------------------------------------------------------------
# uniform interface
# ---------------------------------------------------------------------------

_INIT = {"gcn": init_gcn, "pna": init_pna,
         "meshgraphnet": init_meshgraphnet, "graphcast": init_graphcast}
_FWD = {"gcn": gcn_forward, "pna": pna_forward,
        "meshgraphnet": meshgraphnet_forward, "graphcast": graphcast_forward}


def init_gnn_params(gen: torch.Generator | None, cfg: GNNConfig,
                    device: str | torch.device | None = None):
    """Parameters of ``cfg``'s architecture, drawn from ``gen`` on
    ``device`` (default ``gen``'s; the JAX package's keys and shapes,
    other numbers); ``device="meta"`` gives shapes and dtypes only
    (``gen`` may be None)."""
    device = torch.device(device if device is not None else gen.device)
    p = _INIT[cfg.arch](gen, cfg, device)
    if cfg.feature_table:
        p["features"] = torch.randn((cfg.feature_table, cfg.d_in),
                                    generator=gen, device=device) * 0.1
    return p


def gnn_forward(cfg: GNNConfig, params, batch, lay: Layouts | None = None):
    lay = lay if lay is not None else Layouts()
    if cfg.feature_table:
        batch = dict(batch)
        x = _gather(params["features"], batch["nodes"], lay)
        batch["x"] = x * batch["node_valid"][:, None].float()
    return _FWD[cfg.arch](cfg, params, batch, lay)


def gnn_loss(cfg: GNNConfig, params, batch) -> torch.Tensor:
    lay = Layouts()
    out = gnn_forward(cfg, params, batch, lay)
    if cfg.task == "node_class":
        labels = batch["labels"]
        if "n_seeds" in batch:   # sampled training: loss on seeds only
            out = out[: labels.shape[0]]
        return softmax_cross_entropy(out, labels)
    if cfg.task == "node_reg":
        t = batch["targets"]
        if "n_seeds" in batch and out.shape[0] != t.shape[0]:
            out = out[: t.shape[0]]   # sampled training: loss on seeds only
        return mse_loss(out, t)
    if cfg.task == "graph_reg":  # molecule: pool by graph id then regress
        n_graphs = batch["graph_targets"].shape[0]
        pooled = _seg("sum", out, batch["graph_id"], n_graphs, lay)
        return mse_loss(pooled, batch["graph_targets"])
    raise ValueError(cfg.task)

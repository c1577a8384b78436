"""Inputs of a CommonGraph window configuration, made on the device.

The distribution of ``repro_torch.configs.commongraph.commongraph_edges``,
drawn with a ``torch.Generator`` on the run's device instead of numpy on
the host (numpy takes 84 s at ``window_64x``): the common graph is R-MAT
(Graph500's a, b, c; duplicates and self-loops dropped, shuffled, cut to
``cg_edges``), and each snapshot adds exactly ``delta_edges`` distinct
uniform edges absent from the common graph. Weights are
:func:`edge_weights`, bit for bit the frozen numpy ``edge_weights``. The
same seed on the same kind of device gives the same inputs.

Configuration keys: ``n_nodes``, ``cg_edges``, ``delta_edges``,
``n_snapshots``.
"""

from __future__ import annotations

import numpy as np
import torch

from bench.inputs import Inputs, read_only
from bench.inputs.draw import absent_keys, edge_weights, generator, rmat_keys


def _host(keys: torch.Tensor, n: int):
    """(src, dst, w) numpy arrays of keys on the device."""
    return ((keys // n).to(torch.int32).cpu().numpy(),
            (keys % n).to(torch.int32).cpu().numpy(),
            edge_weights(keys).cpu().numpy())


def make(config: dict, seed: int, device) -> Inputs:
    n = int(config["n_nodes"])
    s = int(config["n_snapshots"])
    e_d = int(config["delta_edges"])
    gen = generator(seed, device)
    cg_keys = rmat_keys(n, int(config["cg_edges"]), gen, device)
    cg = _host(cg_keys, n)
    table = torch.sort(cg_keys).values
    del cg_keys
    rows = [_host(absent_keys(n, e_d, table, gen, device), n)
            for _ in range(s)]
    del table
    delta = tuple(np.stack([r[i] for r in rows]) for i in range(3))
    del rows
    read_only(*cg, *delta)
    n_cg = int(cg[0].size)
    min_bytes = 12 * (n_cg + s * e_d) + 4 * n * s

    def snapshot_edges(i: int):
        return [cg, tuple(a[i] for a in delta)]

    return Inputs(num_nodes=n, num_snapshots=s, common_graph=cg[:2],
                  min_query_bytes=min_bytes,
                  data=dict(cg=cg, delta=delta),
                  snapshot_edges=snapshot_edges)

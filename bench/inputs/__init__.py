"""The benchmark's inputs: one module per kind of configuration, named by
the configuration's ``inputs`` key, each with ``make(config, seed,
device) -> Inputs``. Both sides get the same inputs: the driver builds the
program's state from ``data``; the reference reads each snapshot's own
edge list from ``snapshot_edges``.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np
import torch

EdgeList = tuple[np.ndarray, np.ndarray, np.ndarray]  # int32 src, dst; f32 w


@dataclasses.dataclass
class Inputs:
    """What one run's seed gives both sides.

    ``common_graph`` is the edges every snapshot holds, int32 ``(src,
    dst)``, from which the traffic picks its sources; ``min_query_bytes`` the
    least bytes one query must move: every edge of the common graph and
    of each snapshot's Δ read once (12 bytes an edge) and every
    snapshot's answer written once (4 bytes a vertex). ``data`` is what
    the driver builds the program's state from (read-only numpy arrays);
    ``snapshot_edges(s)`` is snapshot ``s``'s own edge list, in parts
    (numpy arrays or tensors on the run's device).
    """

    num_nodes: int
    num_snapshots: int
    common_graph: tuple[np.ndarray, np.ndarray]
    min_query_bytes: int
    data: dict
    snapshot_edges: Callable[[int], "list[EdgeList]"]


def read_only(*arrays: np.ndarray) -> None:
    """Make arrays handed to the program read-only, so that a write into
    the benchmark's inputs raises instead of changing the reference's."""
    for a in arrays:
        a.flags.writeable = False


def on_device(a, device) -> torch.Tensor:
    """An input array (numpy, read-only ones included: the benchmark
    never writes into its inputs, or a tensor) on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(a).to(device)

"""Config-layer plumbing of the port: mesh-axis handles and cells.

Counterpart of ``repro.configs.base``, with only what the CommonGraph
cell (``configs/commongraph.py``) reads. A *cell* is (computation x input
shape): a step function and its arguments. The reference's arguments are
``ShapeDtypeStruct`` s that its dry run lowers on a production mesh; the
port's are meta-device tensors (``torch.empty(..., device="meta")``: a
shape and a dtype, never allocated), and the same cell runs concretely on
whatever snapshot mesh (``launch/mesh.py``) is at hand, from concrete
inputs of those shapes.

Not ported: ``named``, ``with_sharding`` and ``make_constrainer``, the
reference's XLA sharding helpers (``NamedSharding`` pytrees and
``with_sharding_constraint``). The port places each lane shard on its
device explicitly (``core/trigrid.py`` ``_shard_snapshot_axis``), so
nothing here annotates a tensor; the dry run and the model cells that
use those helpers wait for ROADMAP A10.4.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Logical axis handles; batch may span ('pod', 'data') or just
    ('data',). Works on the port's ``SnapshotMesh`` and on any object with
    ``axis_names`` and a ``shape`` mapping of axis name to extent."""

    batch: tuple[str, ...] = ("data",)
    fsdp: str = "data"
    model: str = "model"

    @staticmethod
    def for_mesh(mesh) -> "MeshAxes":
        names = tuple(mesh.axis_names)
        if "pod" in names:
            return MeshAxes(batch=("pod", "data"))
        return MeshAxes(batch=("data",))

    def n_batch_shards(self, mesh) -> int:
        return math.prod(mesh.shape[a] for a in self.batch)


@dataclasses.dataclass
class Cell:
    """One (computation x shape) cell: ``fn(*args)`` is one step.

    ``args`` are meta-device tensors (or pytrees of them) of the step's
    exact shapes and dtypes; concrete tensors of those shapes run it.

    ``lane_args`` replaces the reference's ``in_specs``/``out_specs``:
    ``PartitionSpec`` s have no torch counterpart, and the one axis the
    port splits is the lane (snapshot) axis over the mesh's batch axes.
    It names the arguments whose leading axis is that lane axis — the
    reference's ``P(batch, ...)`` entries, split into contiguous slices,
    one per device. Every other argument is whole on every device, where
    the reference may split it over ``model`` (see the cell's docstring).
    Outputs are gathered in lane order onto the mesh's first device.
    """

    name: str
    fn: Callable
    args: tuple
    lane_args: tuple[int, ...] = ()
    donate: tuple[int, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)

"""Config-layer plumbing of the port: mesh-axis handles, partition specs
and cells.

Counterpart of ``repro.configs.base``. A *cell* is (computation x input
shape): a step function, its arguments and the reference's sharding specs
for every argument and output. The reference's arguments are
``ShapeDtypeStruct`` s that its dry run lowers on a production mesh; the
port's are meta-device tensors (``torch.empty(..., device="meta")``: a
shape and a dtype, never allocated), which ``launch/dryrun.py`` traces,
and the same cell runs concretely on the card from concrete inputs of
those shapes.

:class:`PartitionSpec` is the port's own spec: per dimension an axis
name, a tuple of names, or ``None``, read as a tuple like JAX's
``PartitionSpec``. It annotates nothing: the port runs a model cell whole
on one card, and its specs only feed the dry run's arithmetic,
:func:`shard_shape` and :func:`per_device_bytes`, the counterparts of the
reference's ``named`` and ``with_sharding``: what each chip of the
reference's layout holds.

Not ported: ``make_constrainer``. ``with_sharding_constraint`` changes
no value, and the port's models dropped ``constrain``
(``models/transformer.py``) and ``latent_constrainer``
(``models/common.py``). The one axis the port splits is the lane axis of
the CommonGraph cell, placed device by device (``core/trigrid.py``
``_shard_snapshot_axis``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves


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


class PartitionSpec:
    """Per dimension of an array: the mesh axis it is split over (a name),
    the axes (a tuple of names, split over their product), or ``None``
    (whole). Reads as a tuple, as JAX's ``PartitionSpec`` does, and a
    one-name tuple reads as the name, as JAX normalizes it. Not a tuple
    itself, so a spec is one leaf of a spec tree (``repro_torch.tree``)."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        self.dims = tuple(d[0] if isinstance(d, tuple) and len(d) == 1
                          else d for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __eq__(self, other):
        return isinstance(other, PartitionSpec) and self.dims == other.dims

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"PartitionSpec{self.dims!r}"


P = PartitionSpec


def shard_shape(shape, spec: PartitionSpec | None, mesh) -> tuple[int, ...]:
    """The shape of one device's shard of an array of ``shape`` split by
    ``spec`` over ``mesh`` (an object with a ``shape`` mapping of axis
    name to extent), by JAX's rule: a dimension split over axes whose
    extents multiply to k must divide by k, or ``ValueError``. ``None``
    means replicated; a spec longer than the rank, or naming an axis
    twice, raises too."""
    dims = tuple(spec) if spec is not None else ()
    if len(dims) > len(shape):
        raise ValueError(f"spec {spec} has {len(dims)} entries for an array "
                         f"of rank {len(shape)}")
    used = [a for d in dims if d is not None
            for a in (d if isinstance(d, tuple) else (d,))]
    if len(set(used)) != len(used):
        raise ValueError(f"spec {spec} names a mesh axis twice")
    out = []
    for i, size in enumerate(shape):
        d = dims[i] if i < len(dims) else None
        k = (1 if d is None else math.prod(
            mesh.shape[a] for a in (d if isinstance(d, tuple) else (d,))))
        if size % k:
            raise ValueError(f"dimension {i} of {tuple(shape)} is split "
                             f"{k} ways by {spec}, which does not divide it")
        out.append(size // k)
    return tuple(out)


def per_device_bytes(tree, spec_tree, mesh) -> int:
    """Bytes one device of ``mesh`` holds of the tensors of ``tree``, each
    split by its spec in ``spec_tree`` (a tree of the same structure whose
    leaves are :class:`PartitionSpec` s or ``None``)."""
    leaves, specs = tree_leaves(tree), tree_leaves(spec_tree)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} tensors and {len(specs)} specs")
    return sum(math.prod(shard_shape(t.shape, s, mesh)) * t.element_size()
               for t, s in zip(leaves, specs))


@dataclasses.dataclass
class Cell:
    """One (computation x shape) cell: ``fn(*args)`` is one step.

    ``args`` are meta-device tensors (or pytrees of them) of the step's
    exact shapes and dtypes; concrete tensors of those shapes run it.
    ``in_specs`` and ``out_specs`` are the reference's sharding specs, one
    :class:`PartitionSpec` per argument and output leaf: the layout the
    dry run reports per device. The port runs a model cell whole on one
    card. ``lane_args`` names the arguments whose leading axis is a lane
    axis that the port itself splits over a ``SnapshotMesh`` (the
    CommonGraph cell's): contiguous slices, one per device; outputs are
    gathered in lane order onto the mesh's first device. ``trace_key`` is
    what ``fn`` takes from the mesh, ``None`` where it takes nothing: the
    cells of one (arch, shape) whose keys are equal run the same step on
    every mesh, so the dry run traces them once.
    """

    name: str
    fn: Callable
    args: tuple
    in_specs: Any = None
    out_specs: Any = None
    lane_args: tuple[int, ...] = ()
    donate: tuple[int, ...] = ()
    meta: dict = dataclasses.field(default_factory=dict)
    trace_key: Any = None


def meta_tensor(shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A meta-device tensor: a shape and a dtype, never allocated."""
    return torch.empty(shape, dtype=dtype, device="meta")

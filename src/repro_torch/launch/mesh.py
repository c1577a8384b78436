"""Meshes of the port: the snapshot mesh, a 1-D ``data`` axis of devices
(counterpart of ``repro.launch.mesh.make_snapshot_mesh``), and the
reference's production and local meshes.

The batched CommonGraph executors (``run_direct_hop_batched``,
``run_plan_batched``, the batched window slide, the stream and the query
service) split their lane (snapshot or window) axis into contiguous
slices over this axis, one per device (``core/trigrid.py``
``_shard_snapshot_axis``): the paper's "breaks the sequential dependency"
parallelism mapped onto cards.

The port's mesh is an explicit tuple of ``torch.device`` s and may name a
device more than once: four slices on one card (or on the CPU) run the
same split as four cards, which is how the tests and ``chip_smoke.py``
exercise it on one device. The executors' state lies on the mesh's first
device, the store's, and their results are gathered there. A CommonGraph
window too large for one device is placed instead
(``configs/commongraph.py`` ``place_window``): each device keeps its own
lanes from set-up on, only the common graph's ``[N]`` fixpoint row comes
from the first device each step, and nothing is gathered.

The production meshes (``make_production_mesh``: 16 x 16 chips, or 2
pods of them) hold no devices: the port places no tensor on 256 chips,
so they only feed the dry run's arithmetic (``launch/dryrun.py``: what
each chip of the reference's layout holds). ``make_local_mesh`` is the
``(1, n)`` mesh of the local cards that a model cell runs on concretely.
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _canonical(device) -> torch.device:
    """``device`` as tensors report it: a CUDA device without an index is
    the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class SnapshotMesh:
    """A 1-D ``data`` mesh over ``devices`` (repeats allowed); ``shape``
    reads like the reference's ``mesh.shape["data"]``."""

    devices: "tuple[torch.device, ...]"
    axis_names: "tuple[str, ...]" = ("data",)

    def __post_init__(self):
        devices = tuple(_canonical(d) for d in self.devices)
        if not devices:
            raise ValueError("a snapshot mesh needs at least one device")
        kinds = {d.type for d in devices}
        if len(kinds) > 1:
            raise ValueError(f"a snapshot mesh spans one kind of device, "
                             f"got {sorted(kinds)}")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> "dict[str, int]":
        """``{"data": number of devices}``."""
        return {"data": len(self.devices)}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of ``dims`` (one extent per name of ``axis_names``)
    over ``devices`` in row-major order, or over none (an abstract mesh,
    like JAX's ``AbstractMesh``). ``shape`` reads like the reference's
    ``mesh.shape``: axis name to extent."""

    axis_names: "tuple[str, ...]"
    dims: "tuple[int, ...]"
    devices: "tuple[torch.device, ...]" = ()

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.dims)} extents")
        devices = tuple(_canonical(d) for d in self.devices)
        if devices and len(devices) != math.prod(self.dims):
            raise ValueError(f"a {self.dims} mesh needs "
                             f"{math.prod(self.dims)} devices, got "
                             f"{len(devices)}")
        object.__setattr__(self, "devices", devices)

    @property
    def shape(self) -> "dict[str, int]":
        return dict(zip(self.axis_names, self.dims))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production mesh, abstract: 16 x 16 = 256 chips
    over ``("data", "model")``, or 2 pods of them (512 chips) over
    ``("pod", "data", "model")``."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_local_mesh(devices=None) -> Mesh:
    """``(1, n)`` over ``("data", "model")``: ``devices``, by default every
    local card. Without a card and without ``devices`` it raises: there
    is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_local_mesh() spans the local cards and "
                               "found none; pass devices= to build a mesh "
                               "of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(("data", "model"), (1, len(devices)), tuple(devices))


def make_snapshot_mesh(devices=None) -> SnapshotMesh:
    """1-D ``data`` mesh over ``devices``, by default every local card
    (``cuda:0`` … ``cuda:{n-1}``). Without a card and without ``devices``
    it raises: there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_snapshot_mesh() spans the local cards "
                               "and found none; pass devices= to build a "
                               "mesh of other devices")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return SnapshotMesh(tuple(devices))


def mesh_led_by(device) -> SnapshotMesh:
    """The mesh evolve's ``--shard`` splits over: every local card with
    ``device`` first (``cuda:k``, then the others in index order), or the
    one-device mesh of a CPU ``device``. The executors gather their
    results on the first device, where the store lies."""
    device = _canonical(device)
    if device.type != "cuda":
        return make_snapshot_mesh([device])
    others = [torch.device("cuda", i) for i in range(torch.cuda.device_count())
              if i != device.index]
    return make_snapshot_mesh([device] + others)

"""Shared helpers of the dry-run tests (``test_torch_dryrun*.py``): the two
production meshes in both packages, the reference's per-device bytes
(``NamedSharding.shard_shape`` x itemsize over its arguments and
``jax.eval_shape``'s outputs under the abstract mesh), spec trees read as
tuples, and one check of a family's cells on both meshes.

The reference builds its cells without devices on ``AbstractMesh``es; its
own dry run cannot lower them on this tree's jax (ROADMAP §C), so the
tests hold the port against its specs, shapes and dtypes."""

import math

import jax
import numpy as np
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import make_cell as j_make_cell
from repro_torch.configs import make_cell as t_make_cell
from repro_torch.configs.base import PartitionSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.meta_trace import trace_step
from repro_torch.tree import tree_leaves, tree_map

J_MESHES = (AbstractMesh((16, 16), ("data", "model")),
            AbstractMesh((2, 16, 16), ("pod", "data", "model")))
T_MESHES = (make_production_mesh(), make_production_mesh(multi_pod=True))


def _is_spec(x) -> bool:
    return isinstance(x, JP) or x is None


def j_spec_tuples(tree):
    """The reference's spec tree with each ``PartitionSpec`` as a tuple."""
    return jax.tree.map(lambda s: ("spec", tuple(s)), tree, is_leaf=_is_spec)


def t_spec_tuples(tree):
    """The port's spec tree with each :class:`PartitionSpec` as a tuple."""
    assert all(isinstance(s, PartitionSpec) for s in tree_leaves(tree))
    return tree_map(lambda s: ("spec", tuple(s)), tree)


def j_bytes(mesh, specs, structs) -> int:
    """Sum over ``structs`` of their shards' bytes under ``specs``."""
    spec_leaves = jax.tree.leaves(specs, is_leaf=_is_spec)
    leaves = jax.tree.leaves(structs)
    assert len(spec_leaves) == len(leaves)
    return sum(math.prod(NamedSharding(mesh, s if s is not None else JP())
                         .shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
               for a, s in zip(leaves, spec_leaves))


def j_outputs(cell, mesh):
    """``jax.eval_shape`` of the reference cell's step on its mesh."""
    with jax.sharding.use_abstract_mesh(mesh):
        return jax.eval_shape(cell.fn, *cell.args)


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def shapes_and_dtypes(leaves):
    return [(tuple(a.shape), dtype_name(a.dtype)) for a in leaves]


def check_cell_on_both_meshes(arch: str, shape: str) -> dict:
    """The port's cell of (arch, shape) against the reference's on both
    production meshes: the name and donation, every argument's shape and
    dtype, the spec trees, the per-device argument and output bytes of
    the dry run's record (``dryrun._record``) against the reference's
    ``shard_shape`` sums, and the outputs' shapes and dtypes (one meta
    trace per distinct step) against ``jax.eval_shape``'s (on the first
    mesh: no output's shape depends on the mesh). Returns the records by
    mesh."""
    records, traces, j_out = {}, {}, None
    for jm, tm in zip(J_MESHES, T_MESHES):
        jc, tc = j_make_cell(arch, shape, jm), t_make_cell(arch, shape, tm)
        assert tc.name == jc.name and tc.donate == jc.donate
        assert shapes_and_dtypes(tree_leaves(tc.args)) == \
            shapes_and_dtypes(jax.tree.leaves(jc.args))
        assert t_spec_tuples(tc.in_specs) == j_spec_tuples(jc.in_specs)
        assert t_spec_tuples(tc.out_specs) == j_spec_tuples(jc.out_specs)
        if tc.trace_key not in traces:
            traces[tc.trace_key] = trace_step(tc.fn, tc.args)
        out, trace = traces[tc.trace_key]
        if j_out is None:
            j_out = j_outputs(jc, jm)
        assert shapes_and_dtypes(tree_leaves(out)) == \
            shapes_and_dtypes(jax.tree.leaves(j_out))
        rec = dryrun._record(tc, tm, trace, out, 0.0)
        assert rec["mem_per_device"] == {
            "argument_bytes": j_bytes(jm, jc.in_specs, jc.args),
            "output_bytes": j_bytes(jm, jc.out_specs, j_out)}, tm.shape
        assert rec["mesh"] == dict(jm.shape)
        assert rec["collective_bytes"] == {} and rec["compile_s"] is None
        one = rec["one_device"]
        assert one["peak_bytes"] == one["argument_bytes"] + one["temp_bytes"]
        assert one["argument_bytes"] >= sum(
            t.numel() * t.element_size() for t in tree_leaves(tc.args))
        records[tuple(tm.shape.items())] = rec
    return records

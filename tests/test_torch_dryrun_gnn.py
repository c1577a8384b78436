"""The GNN family's dry-run cells (``repro_torch.configs.gnn_family``) held
against the JAX package's: the batch specs and meta batches of every
(arch, shape) against ``_graph_input_specs`` (graphcast's derived mesh
graph and the sampled shape's ``subgraph_shapes`` sizes included), the
parameter specs and meta parameters against ``jax.eval_shape`` of the
reference's init, and all 16 cells on both production meshes
(``_torch_dryrun.check_cell_on_both_meshes``).

gcn-cora/full_graph_sm at its own (small) size runs concretely on the
CPU through the port's cell and the reference's jitted cell, from the
reference's seed-0 weights (``interop.params_from_arrays``) and the
port's seeded batch, with ``test_torch_gnn``'s tolerances: the loss
within 1e-5 of its magnitude, the gradient norm within 1e-4, parameters
within 2e-5, ``v`` within 1e-3 of each leaf's largest.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from _torch_dryrun import (  # noqa: E402
    J_MESHES,
    T_MESHES,
    check_cell_on_both_meshes,
    j_spec_tuples,
    shapes_and_dtypes,
    t_spec_tuples,
)
from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import gnn_family as jgnn  # noqa: E402
from repro.configs.base import MeshAxes as JMeshAxes  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.configs import gnn_family as tgnn  # noqa: E402
from repro_torch.configs.base import MeshAxes  # noqa: E402
from repro_torch.data import DataCursor  # noqa: E402
from repro_torch.interop import params_from_arrays  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models.gnn import init_gnn_params  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

GNN_ARCHS = ["pna", "graphcast", "gcn-cora", "meshgraphnet"]
LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 2e-5


@pytest.mark.parametrize("shape", list(jgnn.GNN_SHAPES))
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_batch_and_param_specs_equal_the_reference(arch, shape):
    """On both meshes: the meta batch's keys, shapes and dtypes and its
    specs; the meta parameters against ``jax.eval_shape`` of the init;
    their specs (the feature table row-split on the sampled shape)."""
    jcfg = jgnn._arch_shape_cfg(j_get_arch(arch)[0], shape)
    tcfg = tgnn._arch_shape_cfg(t_get_arch(arch)[0], shape)
    jparams = jax.eval_shape(lambda: jgnn.init_gnn_params(
        jax.random.PRNGKey(0), jcfg))
    tparams = init_gnn_params(None, tcfg, device="meta")
    assert shapes_and_dtypes(tree_leaves(tparams)) == \
        shapes_and_dtypes(jax.tree.leaves(jparams))
    for jm, tm in zip(J_MESHES, T_MESHES):
        jb, jspecs = jgnn._graph_input_specs(jcfg, shape, JMeshAxes.for_mesh(jm))
        tb, tspecs = tgnn._graph_input_specs(tcfg, shape, MeshAxes.for_mesh(tm))
        assert sorted(tb) == sorted(jb)
        assert {k: shapes_and_dtypes([v]) for k, v in tb.items()} == \
            {k: shapes_and_dtypes([v]) for k, v in jb.items()}
        assert t_spec_tuples(tspecs) == j_spec_tuples(jspecs)
        assert t_spec_tuples(tgnn.gnn_param_specs(
            tcfg, tparams, MeshAxes.for_mesh(tm))) == j_spec_tuples(
            jgnn.gnn_param_specs(jcfg, jparams, JMeshAxes.for_mesh(jm)))


@pytest.mark.parametrize("shape", list(jgnn.GNN_SHAPES))
@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_gnn_cells_hold_the_reference_layout(arch, shape):
    check_cell_on_both_meshes(arch, shape)


def test_meta_batch_matches_the_concrete_batch():
    """``shape_batch`` (concrete) and ``_graph_input_specs`` (meta) give
    the same keys, shapes and dtypes."""
    for arch, shape in (("gcn-cora", "full_graph_sm"), ("pna", "molecule"),
                        ("graphcast", "full_graph_sm")):
        cfg = tgnn._arch_shape_cfg(t_get_arch(arch)[0], shape)
        meta, _ = tgnn._graph_input_specs(cfg, shape, MeshAxes())
        got = tgnn.shape_batch(cfg, shape, DataCursor(0, 0), device="cpu")
        assert {k: shapes_and_dtypes([v]) for k, v in got.items()} == \
            {k: shapes_and_dtypes([v]) for k, v in meta.items()}


def test_gcn_cora_full_graph_sm_cell_runs_like_the_reference():
    jcfg = jgnn._arch_shape_cfg(j_get_arch("gcn-cora")[0], "full_graph_sm")
    tcfg = tgnn._arch_shape_cfg(t_get_arch("gcn-cora")[0], "full_graph_sm")
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jcell = jgnn.make_gnn_cell(j_get_arch("gcn-cora")[0], "full_graph_sm",
                               jmesh)
    tcell = tgnn.make_gnn_cell(t_get_arch("gcn-cora")[0], "full_graph_sm",
                               make_local_mesh(["cpu"]))
    jp = jgnn.init_gnn_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    tb = tgnn.shape_batch(tcfg, "full_graph_sm", DataCursor(0, 0), "cpu")
    jb = {k: np.asarray(v) for k, v in tb.items()}
    jp2, jo2, jm = jax.jit(jcell.fn)(jp, j_adamw_init(jp), jb)
    tp2, to2, tm = tcell.fn(tp, adamw_init(tp), tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        LOSS_TOL * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        GRAD_TOL * abs(float(jm["grad_norm"]))
    assert int(to2.count) == int(jo2.count) == 1
    for got, want in zip(tree_leaves(tp2), jax.tree.leaves(jp2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=PARAM_TOL)
    for got, want in zip(tree_leaves(to2.v), jax.tree.leaves(jo2.v)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max())

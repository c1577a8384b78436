"""DIEN's dry-run cells (``repro_torch.configs.recsys_family``) held
against the JAX package's: the parameter specs (the item table row-split
over ``model``) and meta parameters against ``jax.eval_shape`` of the
reference's init, the batch specs and meta batches of every shape, and
the 4 cells on both production meshes
(``_torch_dryrun.check_cell_on_both_meshes``).

At the reduced config (1,000 items, sequence 10), on a small train shape
registered in both packages' ``RECSYS_SHAPES`` (32 rows), the train cell
runs concretely on the CPU through the port's cell and the reference's
jitted cell from the reference's seed-0 weights and batch, with
``test_torch_dien``'s tolerances: the loss within 1e-5 relative, the
gradient norm within 1e-4 relative, parameters within 2e-5; and the
serve cell's logits within 1e-5 of the largest.
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
from repro.configs import recsys_family as jrec  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.configs.base import MeshAxes as JMeshAxes  # noqa: E402
from repro.data import DataCursor as JCursor  # noqa: E402
from repro.data import dien_batch as j_dien_batch  # noqa: E402
from repro.models import dien as jdien  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.configs import recsys_family as trec  # noqa: E402
from repro_torch.configs import reduced_config as t_reduced_config  # noqa: E402
from repro_torch.configs.base import MeshAxes  # noqa: E402
from repro_torch.data import DataCursor  # noqa: E402
from repro_torch.interop import params_from_arrays  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models.dien import init_dien_params  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

FWD_TOL, LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4, 2e-5
TINY = {"tiny_train": dict(kind="train", batch=32),
        "tiny_serve": dict(kind="serve", batch=32)}


def test_specs_and_abstract_state_equal_the_reference():
    jcfg = jrec.DIENConfig(name="dien")
    jparams = jax.eval_shape(lambda: jdien.init_dien_params(
        jax.random.PRNGKey(0), jcfg))
    tcfg = t_get_arch("dien")[0]
    tparams = init_dien_params(None, tcfg, device="meta")
    assert shapes_and_dtypes(tree_leaves(tparams)) == \
        shapes_and_dtypes(jax.tree.leaves(jparams))
    for jm, tm in zip(J_MESHES, T_MESHES):
        jax_, tax = JMeshAxes.for_mesh(jm), MeshAxes.for_mesh(tm)
        assert t_spec_tuples(trec.dien_param_specs(tcfg, tparams, tax)) == \
            j_spec_tuples(jrec.dien_param_specs(jcfg, jparams, jax_))
        assert t_spec_tuples(trec._batch_specs(tax)) == \
            j_spec_tuples(jrec._batch_specs(jax_))
    for b, label in ((512, False), (65_536, True), (1, False)):
        got = trec._abstract_batch(tcfg, b, label)
        want = jrec._abstract_batch(jcfg, b, label)
        assert {k: shapes_and_dtypes([v]) for k, v in got.items()} == \
            {k: shapes_and_dtypes([v]) for k, v in want.items()}


@pytest.mark.parametrize("shape", list(jrec.RECSYS_SHAPES))
def test_dien_cells_hold_the_reference_layout(shape):
    check_cell_on_both_meshes("dien", shape)


def test_meta_batches_match_the_concrete_batches():
    cfg = trec.reduced_recsys_config(t_get_arch("dien")[0])
    for shape, sh in trec.RECSYS_SHAPES.items():
        if sh["kind"] == "retrieval":
            continue   # its candidates are the cell's own keys (above)
        got = trec.shape_batch(cfg, shape, DataCursor(0, 0), "cpu", 4)
        meta = trec._abstract_batch(cfg, 4, sh["kind"] == "train")
        assert {k: shapes_and_dtypes([v]) for k, v in got.items()} == \
            {k: shapes_and_dtypes([v]) for k, v in meta.items()}


@pytest.fixture
def tiny(monkeypatch):
    for name, sh in TINY.items():
        monkeypatch.setitem(jrec.RECSYS_SHAPES, name, dict(sh))
        monkeypatch.setitem(trec.RECSYS_SHAPES, name, dict(sh))


def _cells(shape):
    jcfg, _ = j_reduced_config("dien")
    tcfg, _ = t_reduced_config("dien")
    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jp = jdien.init_dien_params(jax.random.PRNGKey(0), jcfg)
    jb = j_dien_batch(JCursor(0, 0), 32, jcfg.seq_len, jcfg.n_items,
                      jcfg.n_cats)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    if TINY[shape]["kind"] == "serve":
        jb = {k: v for k, v in jb.items() if k != "label"}
        del tb["label"]
    return (jrec.make_recsys_cell(jcfg, shape, jmesh),
            trec.make_recsys_cell(tcfg, shape, make_local_mesh(["cpu"])),
            jp, params_from_arrays(jax.tree.map(np.asarray, jp), "cpu"),
            jb, tb)


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def test_tiny_train_cell_runs_like_the_reference(tiny):
    jcell, tcell, jp, tp, jb, tb = _cells("tiny_train")
    jp2, jo2, jm = jax.jit(jcell.fn)(jp, j_adamw_init(jp), jb)
    tp2, to2, tm = tcell.fn(tp, adamw_init(tp), tb)
    assert _rel(tm["loss"], jm["loss"]) < LOSS_TOL
    assert _rel(tm["grad_norm"], jm["grad_norm"]) < GRAD_TOL
    assert int(to2.count) == int(jo2.count) == 1
    for got, want in zip(tree_leaves(tp2), jax.tree.leaves(jp2)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=PARAM_TOL)


def test_tiny_serve_cell_runs_like_the_reference(tiny):
    jcell, tcell, jp, tp, jb, tb = _cells("tiny_serve")
    want = np.asarray(jax.jit(jcell.fn)(jp, jb))
    got = tcell.fn(tp, tb)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=FWD_TOL * np.abs(want).max())

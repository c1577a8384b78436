"""The LM family's dry-run cells (``repro_torch.configs.lm_family``) held
against the JAX package's: the sharding specs of all five configs
(``lm_param_specs``, ``lm_opt_specs``, the head-dim fallback of llama4's
40 and llama3.2's 24 heads), the meta abstract state against
``jax.eval_shape``'s at full size, and the dense configs' 12 cells on both
production meshes (``_torch_dryrun.check_cell_on_both_meshes``: per-device
argument and output bytes against ``shard_shape`` sums, outputs against
``jax.eval_shape``). The MoE configs' cells are in
``test_torch_dryrun_lm_moe.py``.

At the reduced size, on a small train shape registered in both packages'
``LM_SHAPES`` (4 x 16 tokens): the train cell's ``flops`` against a
closed form from the config, and the cell (stablelm's, and qwen3's with
its MoE) run concretely on the CPU against the reference's jitted cell
from the same weights (carried with
``interop.params_from_arrays``) and batch, with ``test_torch_lm_train``'s
tolerances: the loss within 1e-5 relative, the gradient norm within 1e-5
relative, ``m`` within 1e-5 of each leaf's largest, ``v`` within 1e-3 of
its largest, and each parameter within 2 x lr of the reference's (Adam's
first step is about lr times a gradient's sign), all but 1 in 10^4 of
each leaf's within 1e-4 of its largest.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
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
from repro.configs import lm_family as jlm  # noqa: E402
from repro.configs.base import MeshAxes as JMeshAxes  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.configs import lm_family as tlm  # noqa: E402
from repro_torch.configs.base import MeshAxes  # noqa: E402
from repro_torch.interop import params_from_arrays  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.meta_trace import trace_step  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

LM_ARCHS = ["qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b", "llama3.2-3b",
            "nemotron-4-340b", "stablelm-1.6b"]
DENSE_ARCHS = ["llama3.2-3b", "nemotron-4-340b", "stablelm-1.6b"]
TINY = "tiny_train"
TINY_SHAPE = dict(kind="train", seq=16, batch=4)
LR = 1e-4          # the cells' AdamW step (the reference's defaults)
LOSS_TOL, GRAD_TOL = 1e-5, 1e-5


@pytest.fixture
def tiny(monkeypatch):
    """The small train shape in both packages' ``LM_SHAPES``."""
    monkeypatch.setitem(jlm.LM_SHAPES, TINY, dict(TINY_SHAPE))
    monkeypatch.setitem(tlm.LM_SHAPES, TINY, dict(TINY_SHAPE))
    return TINY


def test_lm_shapes_equal_the_reference():
    assert tlm.LM_SHAPES == jlm.LM_SHAPES


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch):
    """On both meshes, each spec read as a tuple, at the configs' own
    settings (none sets the reference's ``expert_zero1``)."""
    jcfg, tcfg = j_get_arch(arch)[0], t_get_arch(arch)[0]
    assert not jcfg.expert_zero1
    for jm, tm in zip(J_MESHES, T_MESHES):
        jax_, tax = JMeshAxes.for_mesh(jm), MeshAxes.for_mesh(tm)
        jp = jlm.lm_param_specs(jcfg, jax_, tp_size=16)
        tp = tlm.lm_param_specs(tcfg, tax, tp_size=16)
        assert t_spec_tuples(tp) == j_spec_tuples(jp)
        assert t_spec_tuples(tlm.lm_opt_specs(tp)) == \
            j_spec_tuples(jlm.lm_opt_specs(jp, jcfg, jax_))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_abstract_state_equals_eval_shape(arch):
    """Parameters and AdamW state on meta: every leaf's shape and dtype,
    in leaf order, equal the reference's ``jax.eval_shape`` at full
    size."""
    jparams, jopt = jlm.abstract_lm_state(j_get_arch(arch)[0], True)
    tparams, topt = tlm.abstract_lm_state(t_get_arch(arch)[0], True)
    assert all(t.is_meta for t in tree_leaves((tparams, topt)))
    assert shapes_and_dtypes(tree_leaves((tparams, topt))) == \
        shapes_and_dtypes(jax.tree.leaves((jparams, jopt)))
    assert tlm.abstract_lm_state(t_get_arch(arch)[0], False)[1] is None


@pytest.mark.parametrize("shape", list(jlm.LM_SHAPES))
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_cells_hold_the_reference_layout(arch, shape):
    check_cell_on_both_meshes(arch, shape)


def _layer_products(cfg, b, s):
    """FLOPs of one layer's forward products, in order, and the last one
    (the FFN's down projection)."""
    t, d, h, kv, hd, f = (b * s, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.head_dim, cfg.d_ff)
    attn = [2 * t * d * h * hd, 2 * t * d * kv * hd, 2 * t * d * kv * hd,
            2 * b * h * s * s * hd, 2 * b * h * s * s * hd,
            2 * t * h * hd * d]
    ffn = [2 * t * d * f] * (2 if cfg.activation == "swiglu" else 1)
    return attn + ffn + [2 * t * f * d]


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_reduced_train_cell_flops_equal_the_closed_form(arch, tiny):
    """Forward: each layer's products and the head's; the per-layer
    recompute of the backward: the layer's products but its last (the
    non-reentrant checkpoint stops once it has rebuilt what the backward
    reads: the down projection's inputs, before the product runs); the
    backward: two products per forward product (each operand's
    gradient)."""
    cfg = tlm.reduced_lm_config(t_get_arch(arch)[0])
    cell = tlm.make_lm_cell(cfg, tiny, T_MESHES[0])
    _, rec = trace_step(cell.fn, cell.args)
    b, s = TINY_SHAPE["batch"], TINY_SHAPE["seq"]
    layer = _layer_products(cfg, b, s)
    head = 2 * b * s * cfg.d_model * cfg.vocab
    forward = cfg.n_layers * sum(layer) + head
    recompute = cfg.n_layers * sum(layer[:-1])
    assert rec["flops"] == forward + recompute + 2 * forward


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _f64(x):
    return np.asarray(x, dtype=np.float64)


def _run_tiny_cell(arch: str, shape: str):
    """The reduced ``arch``'s cell of ``shape`` in both packages from the
    reference's seed-0 weights and a seeded batch: the reference's jitted
    on a one-device mesh, the port's on ``make_local_mesh(["cpu"])``;
    returns (JAX outputs, port outputs)."""
    jcfg = jlm.reduced_lm_config(j_get_arch(arch)[0])
    tcfg = tlm.reduced_lm_config(t_get_arch(arch)[0])
    jcell = jlm.make_lm_cell(jcfg, shape, _one_device_mesh())
    tcell = tlm.make_lm_cell(tcfg, shape, make_local_mesh(["cpu"]))
    jp = jax.jit(lambda k: jlm.init_lm_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tp = params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    b, s = TINY_SHAPE["batch"], TINY_SHAPE["seq"]
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (b, s),
                                             dtype=np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    jout = jax.jit(jcell.fn)(jp, jlm.adamw_init(jp),
                             {"tokens": jnp.asarray(toks),
                              "labels": jnp.asarray(labels)})
    tout = tcell.fn(tp, adamw_init(tp), {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
    return jout, tout


def _check_train_outputs(jout, tout):
    (jp, jo, jm), (tp, to, tm) = jout, tout
    for key, tol in (("loss", LOSS_TOL), ("grad_norm", GRAD_TOL)):
        want = float(jm[key])
        assert abs(float(tm[key]) - want) <= tol * abs(want), key
    assert int(to.count) == int(jo.count) == 1
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        w = _f64(want)
        diff = np.abs(_f64(got) - w)
        assert diff.max() <= 2 * LR
        assert (diff > 1e-4 * np.abs(w).max()).mean() <= 1e-4
    for tree_t, tree_j, tol in ((to.m, jo.m, GRAD_TOL), (to.v, jo.v, 1e-3)):
        for got, want in zip(tree_leaves(tree_t), jax.tree.leaves(tree_j)):
            w = _f64(want)
            np.testing.assert_allclose(_f64(got), w, rtol=0,
                                       atol=tol * max(np.abs(w).max(), 1e-30))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cells_trace_alike_where_their_trace_keys_agree(arch, monkeypatch):
    """At the reduced size, on small train, prefill and decode shapes, the
    cells on both production meshes: the traces (``flops``,
    ``bytes_accessed``, ``one_device``) are equal wherever the cells'
    ``trace_key`` s are, so one trace serves both; where they differ (a
    MoE config's train and prefill), so do the traces."""
    cfg = tlm.reduced_lm_config(t_get_arch(arch)[0])
    for kind in ("train", "prefill", "decode"):
        monkeypatch.setitem(tlm.LM_SHAPES, f"tiny_{kind}",
                            dict(TINY_SHAPE, kind=kind))
        cells = [tlm.make_lm_cell(cfg, f"tiny_{kind}", m) for m in T_MESHES]
        traces = [trace_step(c.fn, c.args)[1] for c in cells]
        for t in traces:
            del t["trace_s"]
        same_key = cells[0].trace_key == cells[1].trace_key
        assert same_key == (not cfg.is_moe or kind == "decode")
        assert (traces[0] == traces[1]) == same_key, kind


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-moe-30b-a3b"])
def test_tiny_train_cell_runs_like_the_reference(arch, tiny):
    _check_train_outputs(*_run_tiny_cell(arch, tiny))

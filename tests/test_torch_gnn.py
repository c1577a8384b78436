"""The port's GNN training path held against the JAX package on the CPU.

Same inputs (the JAX package's batch and weights, carried across as numpy
arrays with ``interop.params_from_arrays``) go through both packages'
forward, loss, gradients and three AdamW steps, for all four architectures
at reduced size. Aggregations are bit-exact (``test_torch_segment_reduce``),
but matrix products are not: XLA's CPU dots and torch's CPU matmul sum the
products in different orders, so each float32 dot differs by a few ulps
and the difference grows with depth. The tolerances below are set from
that: forward within 1e-5 of the output's largest magnitude, gradients
within 1e-4 of each leaf's largest magnitude, parameters after three steps
of lr 1e-3 within 2e-5 (measured: at most 3e-6).

Also here: padding edges are inert, ``shape_batch`` matches the reference's
abstract ``_graph_input_specs`` (``minibatch_lg`` on a stand-in graph), the data feeders, AdamW, the common
blocks, the config registry, checkpoints and the train CLI on the CPU.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.configs.base import MeshAxes  # noqa: E402
from repro.configs.gnn_family import _arch_shape_cfg as j_arch_shape_cfg  # noqa: E402
from repro.configs.gnn_family import _graph_input_specs  # noqa: E402
from repro.data import DataCursor as JCursor  # noqa: E402
from repro.data import gnn_full_batch as j_full_batch  # noqa: E402
from repro.data import gnn_molecule_batch as j_molecule_batch  # noqa: E402
from repro.launch.train import build as j_build  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models.gnn import gnn_forward as j_forward  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import gnn_family  # noqa: E402
from repro_torch.configs.gnn_family import (  # noqa: E402
    GNN_SHAPES,
    _arch_shape_cfg,
    shape_batch,
)
from repro_torch.data import (  # noqa: E402
    DataCursor,
    gnn_full_batch,
    gnn_molecule_batch,
    uniform_graph,
)
from repro_torch.graph.sampler import subgraph_shapes  # noqa: E402
from repro_torch.interop import params_from_arrays  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.gnn import gnn_forward, gnn_loss, init_gnn_params  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

GNN_ARCHS = ["gcn-cora", "pna", "meshgraphnet", "graphcast"]
FWD_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 2e-5


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _carried(arch):
    """(JAX cfg, port cfg, JAX params, port params, JAX batch, port batch,
    JAX loss_fn, port loss_fn) of the train driver's reduced build."""
    jcfg, _, jinit, jloss, jdata = j_build(arch, True, 8, 128)
    tcfg, _, _, tloss, _ = ttrain.build(arch, True, 8, 128, "cpu")
    jp = jinit(jax.random.PRNGKey(0))
    jb = jdata(JCursor(0, 0))
    tp = params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp, jb, _t(jb), jloss, tloss


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_loss_and_gradients_match_jax(arch):
    jcfg, tcfg, jp, tp, jb, tb, jloss, tloss = _carried(arch)
    assert dataclasses.asdict(tcfg) == {
        k: v for k, v in dataclasses.asdict(jcfg).items() if k != "param_dtype"}
    _close(gnn_forward(tcfg, tp, tb), j_forward(jcfg, jp, jb), FWD_TOL)
    lj, gj = jax.value_and_grad(lambda p: jloss(p, jb))(jp)
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    lt = tloss(tree_unflatten(tp, leaves), tb)
    _close(lt, lj, FWD_TOL)
    gt = torch.autograd.grad(lt, leaves)
    jleaves = jax.tree.leaves(gj)
    assert len(jleaves) == len(gt)
    for g, want in zip(gt, jleaves):
        _close(g, want, GRAD_TOL)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_three_adamw_steps_match_jax(arch):
    _, _, jp, tp, jb, tb, jloss, tloss = _carried(arch)
    jo, to = j_adamw_init(jp), adamw_init(tp)
    for _ in range(3):
        lj, gj = jax.value_and_grad(lambda p: jloss(p, jb))(jp)
        jp, jo, jnorm = j_adamw_update(gj, jo, jp, lr=1e-3, weight_decay=0.0)
        tp, to, lt, tnorm = ttrain.train_step(tloss, tp, to, tb, lr=1e-3)
        _close(lt, lj, FWD_TOL)
        _close(tnorm, jnorm, GRAD_TOL)
    assert int(to.count) == int(jo.count) == 3
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=PARAM_TOL)
    for got, want in zip(tree_leaves(to.v), jax.tree.leaves(jo.v)):
        _close(got, want, 1e-3)


def _padded(arch, batch, extra=16):
    """``batch`` plus ``extra`` padding edges in every edge set (sentinel
    destination, source 0, zero features)."""
    b = dict(batch)
    sets = ([("g2m", "mesh_valid"), ("mesh", "mesh_valid"), ("m2g", "x")]
            if arch == "graphcast" else [("", "x")])
    for prefix, nodes in sets:
        p = f"{prefix}_" if prefix else ""
        feat = f"{p}feat" if prefix else "edge_feat"
        sentinel = b[nodes].shape[0]
        b[f"{p}src"] = torch.cat([b[f"{p}src"],
                                  torch.zeros(extra, dtype=torch.int32)])
        b[f"{p}dst"] = torch.cat([b[f"{p}dst"],
                                  torch.full((extra,), sentinel,
                                             dtype=torch.int32)])
        b[feat] = torch.cat([b[feat], torch.zeros((extra, b[feat].shape[1]))])
    return b


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_padding_edges_are_inert(arch):
    """Edges with the sentinel destination change no real node's output
    (as ``tests/test_models.py::test_gnn_padding_edges_are_inert``)."""
    cfg, _, init, _, data = ttrain.build(arch, True, 8, 128, "cpu")
    gen = torch.Generator().manual_seed(0)
    params = init(gen)
    b = data(DataCursor(0, 0))
    out1 = gnn_forward(cfg, params, b)
    out2 = gnn_forward(cfg, params, _padded(arch, b))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)


def _stand_in_graph(monkeypatch):
    """A small uniform graph for ``minibatch_lg``'s batches, in place of
    ``shape_graph``'s: their shapes depend only on the shape's batch_nodes
    and fanout, not on the graph."""
    graph = uniform_graph(4_096, 100_000, seed=0)
    monkeypatch.setattr(gnn_family, "shape_graph", lambda *_: graph)
    return graph


@pytest.mark.parametrize("arch", GNN_ARCHS)
@pytest.mark.parametrize("shape_id", ["full_graph_sm", "molecule",
                                      "minibatch_lg"])
def test_shape_batch_matches_reference_specs(arch, shape_id, monkeypatch):
    """Same keys, shapes and dtypes as ``_graph_input_specs``; padding
    edges carry the sentinel; one training loss is finite. ``minibatch_lg``
    samples a stand-in graph at the shape's full batch_nodes and fanout."""
    tcfg = _arch_shape_cfg(tconfigs.get_arch(arch)[0], shape_id)
    jcfg = j_arch_shape_cfg(j_get_arch(arch)[0], shape_id)
    specs, _ = _graph_input_specs(jcfg, shape_id, MeshAxes())
    sh = GNN_SHAPES[shape_id]
    minibatch = sh["kind"] == "minibatch"
    graph = _stand_in_graph(monkeypatch) if minibatch else None
    batch = shape_batch(tcfg, shape_id, DataCursor(0, 0), "cpu")
    assert sorted(batch) == sorted(specs)
    for k, s in specs.items():
        assert tuple(batch[k].shape) == tuple(s.shape), k
        assert str(batch[k].dtype).removeprefix("torch.") == str(s.dtype), k
    n = batch["nodes" if minibatch else "x"].shape[0]
    dst = batch["m2g_dst"] if arch == "graphcast" else batch["dst"]
    real = (subgraph_shapes(sh["batch_nodes"], sh["fanout"])[1] if minibatch
            else sh["n_edges"] * sh.get("batch", 1))
    assert int((dst == n).sum()) == dst.shape[0] - real   # the padding
    assert int(dst[:real].max()) < n and int(dst.min()) >= 0
    if arch == "graphcast":
        m = batch["mesh_valid"].shape[0]
        assert m == max(n // 4, 42)
        assert int((batch["g2m_dst"] == m).sum()) == dst.shape[0] - real
        assert int(batch["mesh_dst"].max()) < m
    if shape_id == "molecule":
        assert int(batch["graph_id"].max()) == batch["graph_targets"].shape[0]
    small = dataclasses.replace(tconfigs.reduced_config(arch)[0],
                                d_in=tcfg.d_in, d_out=tcfg.d_out,
                                task=tcfg.task, n_vars=tcfg.n_vars)
    if minibatch:
        assert int(batch["n_seeds"]) == sh["batch_nodes"]
        assert int(batch["nodes"].max()) < graph.num_nodes
        small = dataclasses.replace(small, feature_table=graph.num_nodes)
    params = init_gnn_params(torch.Generator().manual_seed(1), small)
    assert torch.isfinite(gnn_loss(small, params, batch))


def test_shape_batch_is_seeded_and_minibatch_waits(monkeypatch):
    """Every kind's batch is a function of (seed, step): a molecule batch,
    and a ``minibatch_lg`` batch, whose sampled subgraph changes with the
    step and the seed (the minibatch kind no longer waits for a sampler)."""
    cfg = _arch_shape_cfg(tconfigs.get_arch("pna")[0], "molecule")
    a = shape_batch(cfg, "molecule", DataCursor(3, 1), "cpu")
    b = shape_batch(cfg, "molecule", DataCursor(3, 1), "cpu")
    c = shape_batch(cfg, "molecule", DataCursor(3, 2), "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["x"], c["x"])
    cfg = _arch_shape_cfg(tconfigs.get_arch("pna")[0], "minibatch_lg")
    _stand_in_graph(monkeypatch)

    def batch(seed, step):
        return shape_batch(cfg, "minibatch_lg", DataCursor(seed, step), "cpu")
    a, b = batch(3, 1), batch(3, 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    for other in (batch(3, 2), batch(4, 1)):
        for k in ("nodes", "edge_feat", "labels"):
            assert not torch.equal(a[k], other[k]), k
    seeds = a["nodes"][:1_024]
    assert len(set(seeds.tolist())) == 1_024 and bool(a["node_valid"][:1_024].all())


@pytest.mark.parametrize("arch,shape_id,lr", [
    r for r in ttrain.SHAPE_RUNS if r[1] not in ("ogb_products",
                                                 "minibatch_lg")])
def test_shape_run_sets_up_the_full_width_run(arch, shape_id, lr):
    """``shape_run`` is the shape's seeded batch, the architecture's full
    config bound to the shape, seeded parameters and fresh AdamW state.
    (``minibatch_lg``'s full graph and 562 MB feature table stay off the
    CPU: ``test_shape_batch_matches_reference_specs`` samples a stand-in.)"""
    assert {a for a, _, _ in ttrain.SHAPE_RUNS} == set(GNN_ARCHS)
    assert {s for _, s, _ in ttrain.SHAPE_RUNS} == set(GNN_SHAPES)
    assert lr == (1e-4 if arch in ("meshgraphnet", "graphcast") else 1e-3)
    assert dict((r[:2], r[2]) for r in ttrain.SHAPE_RUNS if r[0] == arch)[
        (arch, "minibatch_lg")] == (1e-3 if arch == "gcn-cora" else 1e-4)
    cfg, batch, params, opt, loss_fn, batch_at = ttrain.shape_run(
        arch, shape_id, "cpu", seed=2)
    assert cfg == _arch_shape_cfg(tconfigs.get_arch(arch)[0], shape_id)
    want = shape_batch(cfg, shape_id, DataCursor(2, 0), "cpu")
    assert sorted(batch) == sorted(want)
    assert all(torch.equal(batch[k], want[k]) for k in want)
    later = shape_batch(cfg, shape_id, DataCursor(2, 3), "cpu")
    assert all(torch.equal(batch_at(3)[k], later[k]) for k in later)
    again = init_gnn_params(torch.Generator().manual_seed(2), cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))
    assert int(opt.count) == 0
    assert all(not bool(m.any()) for m in tree_leaves(opt.m))
    if arch == "pna":   # the one cheap enough for a loss at full width here
        assert torch.isfinite(loss_fn(params, batch))


@pytest.mark.parametrize("kind", ["full_node_class", "full_node_reg",
                                  "molecule"])
def test_feeders_match_reference_shapes_and_ranges(kind):
    if kind == "molecule":
        args = (6, 5, 9, 3, 2)
        j = j_molecule_batch(JCursor(0, 0), *args)
        t = gnn_molecule_batch(DataCursor(0, 0), *args, device="cpu")
        per = torch.arange(t["src"].shape[0]) // 9 * 5
        assert bool(((t["src"] - per >= 0) & (t["src"] - per < 5)).all())
        assert torch.equal(t["graph_id"], torch.from_numpy(
            np.array(j["graph_id"])))
    else:
        task = kind.removeprefix("full_")
        j = j_full_batch(JCursor(0, 0), 50, 300, 6, 4, task)
        t = gnn_full_batch(DataCursor(0, 0), 50, 300, 6, 4, task,
                           device="cpu")
        assert int(t["src"].max()) < 50 and int(t["dst"].min()) >= 0
    assert sorted(t) == sorted(j)
    for k in j:
        assert tuple(t[k].shape) == j[k].shape, k
        assert str(t[k].dtype).removeprefix("torch.") == str(j[k].dtype), k
    if "labels" in t:
        assert int(t["labels"].max()) < 4 and int(t["labels"].min()) >= 0


def test_adamw_matches_reference_on_a_tree():
    rng = np.random.default_rng(0)
    shapes = {"b": [(3,), (2, 2)], "a": {"w": (4, 5)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple))
    tparams = params_from_arrays(params, "cpu")
    jp, tp = jax.tree.map(jnp.asarray, params), tparams
    jo, to = j_adamw_init(jp), adamw_init(tp)
    for step in range(4):
        grads = jax.tree.map(lambda p, s=step: p * (3.0 - s), params)
        jp, jo, jn = j_adamw_update(jax.tree.map(jnp.asarray, grads), jo, jp,
                                    lr=1e-2, weight_decay=0.1, max_norm=2.0)
        tp, to, tn = adamw_update(params_from_arrays(grads, "cpu"), to,
                                  tp, lr=1e-2, weight_decay=0.1, max_norm=2.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_common_blocks_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 6)).astype(np.float32) * 3
    g, b = (rng.standard_normal(6).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tcommon.layer_norm(*map(torch.from_numpy, (x, g, b))).numpy(),
        np.asarray(jcommon.layer_norm(x, g, b)), rtol=1e-5, atol=1e-6)
    labels = np.array([0, 5, -1, 2, -1, 1, 0, 3, 4], np.int32)
    np.testing.assert_allclose(
        float(tcommon.softmax_cross_entropy(torch.from_numpy(x),
                                            torch.from_numpy(labels))),
        float(jcommon.softmax_cross_entropy(x, labels)), rtol=1e-6)
    all_masked = torch.full((9,), -1, dtype=torch.int32)
    assert float(tcommon.softmax_cross_entropy(torch.from_numpy(x),
                                               all_masked)) == 0.0
    np.testing.assert_allclose(
        float(tcommon.mse_loss(torch.from_numpy(x), torch.from_numpy(x * 0.5))),
        float(jcommon.mse_loss(x, x * 0.5)), rtol=1e-6)
    gen = torch.Generator().manual_seed(0)
    p = tcommon.mlp_params(gen, (6, 8, 3), norm=True)
    jparams = jcommon.mlp_params(jax.random.PRNGKey(0), (6, 8, 3), norm=True)
    assert jax.tree.map(np.shape, jparams) == tree_map(
        lambda t: tuple(t.shape), p)
    carried = params_from_arrays(jax.tree.map(np.asarray, jparams), "cpu")
    np.testing.assert_allclose(
        tcommon.mlp_apply(carried, torch.from_numpy(x)).numpy(),
        np.asarray(jcommon.mlp_apply(jparams, x)), rtol=1e-5, atol=1e-5)
    w = tcommon.dense_init(gen, 400, 300)
    assert abs(float(w.std()) * 20 - 1) < 0.02


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_configs_and_init_shapes_match_reference(arch):
    tcfg, tfam = tconfigs.get_arch(arch)
    jcfg, jfam = j_get_arch(arch)
    assert tfam == jfam == "gnn"
    strip = lambda c: {k: v for k, v in dataclasses.asdict(c).items()
                       if k != "param_dtype"}
    assert strip(tcfg) == strip(jcfg)
    assert strip(tconfigs.reduced_config(arch)[0]) == strip(
        j_reduced_config(arch)[0])
    small = dataclasses.replace(tconfigs.reduced_config(arch)[0], d_in=5,
                                d_out=3)
    jsmall = dataclasses.replace(j_reduced_config(arch)[0], d_in=5, d_out=3)
    from repro.models.gnn import init_gnn_params as j_init
    want = jax.tree.map(np.shape, j_init(jax.random.PRNGKey(0), jsmall))
    got = tree_map(lambda t: tuple(t.shape),
                   init_gnn_params(torch.Generator().manual_seed(0), small))
    assert got == want


def test_registry_names_what_waits():
    """dien and the LM archs resolve (full and reduced); ``build`` gives
    the LM family (``init_lm_params``, ``lm_loss``, ``lm_batch``); an
    unknown id is a KeyError."""
    assert tconfigs.get_arch("dien")[1] == "recsys"
    assert tconfigs.reduced_config("dien")[0].seq_len == 10
    for arch in ("llama3.2-3b", "qwen3-moe-30b-a3b"):
        assert tconfigs.get_arch(arch)[1] == "lm"
        cfg, family = tconfigs.reduced_config(arch)
        assert family == "lm" and cfg.d_model == 64 and cfg.n_layers == 2
        got, fam, params_init, loss_fn, data_fn = ttrain.build(
            arch, True, 8, 128, "cpu")
        assert (got, fam) == (cfg, "lm")
        params = params_init(torch.Generator().manual_seed(0))
        assert tuple(params["embed"].shape) == (cfg.vocab, cfg.d_model)
        batch = data_fn(DataCursor(0, 0))
        assert tuple(batch["tokens"].shape) == (8, 128)
        assert tuple(batch["labels"].shape) == (8, 128)
        loss = loss_fn(params, batch)
        assert loss.shape == () and math.isfinite(float(loss))
    assert set(tconfigs.ARCH_IDS) == set(tconfigs._MODULES)
    with pytest.raises(KeyError):
        tconfigs.get_arch("resnet")


def test_checkpoint_round_trip(tmp_path):
    cfg, _, init, _, _ = ttrain.build("pna", True, 8, 128, "cpu")
    params = init(torch.Generator().manual_seed(0))
    opt = adamw_init(params)
    mgr = CheckpointManager(str(tmp_path), keep=2, device="cpu")
    for step in (1, 2, 3):
        mgr.save(step, {"params": params, "opt": opt,
                        "cursor": DataCursor(0, step)}, {"loss": 0.5})
    assert mgr.latest_step() == 3
    assert mgr.restore(1) is None          # retention kept the newest two
    back = mgr.restore_latest()
    assert back["cursor"] == DataCursor(0, 3)
    assert isinstance(back["opt"], type(opt))
    for a, b in zip(tree_leaves((params, opt)),
                    tree_leaves((back["params"], back["opt"]))):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_train_cli_on_cpu_decreases_loss(arch):
    losses = ttrain.main(["--arch", arch, "--steps", "4", "--reduced",
                          "--device", "cpu"])
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))


def test_train_cli_resume_continues_bit_identically(tmp_path):
    d = str(tmp_path / "ck")
    straight = ttrain.main(["--arch", "gcn-cora", "--reduced", "--steps", "6",
                            "--device", "cpu"])
    ttrain.main(["--arch", "gcn-cora", "--reduced", "--steps", "4",
                 "--device", "cpu", "--ckpt-dir", d, "--ckpt-every", "2"])
    resumed = ttrain.main(["--arch", "gcn-cora", "--reduced", "--steps", "6",
                           "--device", "cpu", "--ckpt-dir", d,
                           "--ckpt-every", "2", "--resume"])
    assert resumed == straight[4:]


def test_tree_helpers_follow_jax_leaf_order():
    tree = {"z": [1, (2, 3)], "a": {"y": 4, "b": 5}}
    assert tree_leaves(tree) == jax.tree.leaves(tree)
    assert tree_unflatten(tree, range(5)) == jax.tree.unflatten(
        jax.tree.structure(tree), range(5))
    with pytest.raises(ValueError):
        tree_unflatten(tree, range(6))

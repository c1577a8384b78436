"""The port's neighbor sampler and sampled GNN training held against the JAX
package on the CPU.

The sampler (``repro_torch.graph.sampler``, host numpy copied from
``repro.graph.sampler``) must draw the reference's subgraphs bit for bit:
CSR, nodes, validity, local edges and their sentinels, over several seeds,
fanouts and successive calls, on a graph with in-degree-0 vertices. The
(seed, step) feeder must equal a reference ``NeighborSampler`` built on
the same arrays with the same mixed seed. Then, for the four GNN
architectures at reduced size on a small sampled batch (a shape
registered beside ``minibatch_lg``, fanout 3-2, so the subgraph pads from
160 to 1,024 nodes), the JAX package's weights (the feature table
included) are carried across: forward, loss and every gradient within
``test_torch_gnn``'s ``FWD_TOL``/``GRAD_TOL``, and three AdamW steps
within ``PARAM_TOL``. No test builds ``minibatch_lg``'s 114.6M-edge graph.

PNA's forward and gradients are held to the JAX package's float64 values
instead (``jax.enable_x64``), at most ``PNA_ERR_RATIO`` times as far from
them as the JAX package's own float32 values, plus ``FWD_TOL``/
``GRAD_TOL``. A sampled subgraph's last hop has no in-edge, so those
nodes (and seeds without in-neighbors) take the attenuation scaler
``delta / max(log1p(0), 1e-6)``, about 10^5, times the std aggregator's
``sqrt(1e-5)``: every such node gets the same large term, and a node that
aggregates them computes ``m2 - mean^2`` of nearly equal messages, which
cancels. Both packages compute the same formula: on four sampled batches
the JAX package's own float32 forward was 2.7e-5 to 1.5e-4 (relative to
the largest output) from its float64 forward and its gradients up to
3.7e-4, the port's 0.5 to 2.7 times as far, so no float32 pair of them
meets ``FWD_TOL`` there. PNA's loss and its three AdamW steps still meet
the stated tolerances.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.graph import sampler as jsampler  # noqa: E402
from repro.models.gnn import gnn_forward as j_forward  # noqa: E402
from repro.models.gnn import gnn_loss as j_loss  # noqa: E402
from repro.models.gnn import init_gnn_params as j_init  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import gnn_family  # noqa: E402
from repro_torch.data import DataCursor, pipeline  # noqa: E402
from repro_torch.graph import NeighborSampler, SampledSubgraph  # noqa: E402
from repro_torch.graph import sampler as tsampler  # noqa: E402
from repro_torch.interop import params_from_arrays  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models.gnn import gnn_forward, gnn_loss  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves, tree_unflatten  # noqa: E402

GNN_ARCHS = ["gcn-cora", "pna", "meshgraphnet", "graphcast"]
FWD_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-4, 2e-5   # test_torch_gnn's
PNA_ERR_RATIO = 4.0
FANOUTS = [(15, 10), (3, 2), (4,)]
# a small sampled shape: fanout 3-2 makes 16 + 48 + 96 = 160 nodes and 144
# edges, padded to 1,024 and 512
SMALL = "minibatch_xs"
SMALL_SHAPE = dict(kind="minibatch", n_nodes=300, n_edges=30_000,
                   batch_nodes=16, fanout=(3, 2), d_feat=12)


def _graph(n=300, e=1_500, seed=0):
    """(src, dst, n): vertices at or above 2n/3 have no in-edge."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, 2 * n // 3, e).astype(np.int32)
    return src, dst, n


def _seeds(n, count, seed):
    """``count`` distinct seeds, a third of them in-degree 0."""
    rng = np.random.default_rng(seed + 100)
    high = rng.choice(np.arange(2 * n // 3, n), count // 3, replace=False)
    low = rng.choice(2 * n // 3, count - count // 3, replace=False)
    return np.concatenate([low, high]).astype(np.int32)


def _same(got: SampledSubgraph, want):
    for field in ("nodes", "node_valid", "src", "dst"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.n_seeds == want.n_seeds and got.n_local == want.n_local


@pytest.mark.parametrize("fanouts", FANOUTS)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_sampler_draws_match_reference(seed, fanouts):
    """Two successive ``sample`` calls on one sampler draw the reference's
    subgraphs bit for bit, sentinel edges and invalid slots included."""
    src, dst, n = _graph(seed=seed)
    mine = NeighborSampler(src, dst, n, seed=seed)
    ref = jsampler.NeighborSampler(src, dst, n, seed=seed)
    for call in range(2):
        seeds = _seeds(n, 12, seed + call)
        got, want = mine.sample(seeds, fanouts), ref.sample(seeds, fanouts)
        _same(got, want)
        assert not got.node_valid.all()             # degree-0 seeds
        assert int((got.dst == got.n_local).sum()) > 0


def test_csr_matches_reference():
    src, dst, n = _graph()
    mine = NeighborSampler(src, dst, n)
    ref = jsampler.NeighborSampler(src, dst, n)
    np.testing.assert_array_equal(mine._nbr, ref._nbr)
    np.testing.assert_array_equal(mine._offsets, ref._offsets)
    assert mine._nbr.dtype == ref._nbr.dtype == np.int32
    assert mine._offsets.dtype == ref._offsets.dtype == np.int64
    assert mine.num_nodes == n


@pytest.mark.parametrize("fanouts", FANOUTS)
def test_subgraph_shapes_match_reference(fanouts):
    for seeds in (1, 12, 1_024):
        assert tsampler.subgraph_shapes(seeds, fanouts) == \
            jsampler.subgraph_shapes(seeds, fanouts)
    src, dst, n = _graph()
    sub = NeighborSampler(src, dst, n).sample(_seeds(n, 12, 0), fanouts)
    assert (sub.n_local, sub.src.shape[0]) == tsampler.subgraph_shapes(
        12, fanouts)


def test_reseeded_sampler_shares_the_csr_and_draws_as_new():
    src, dst, n = _graph()
    base = NeighborSampler(src, dst, n, seed=3)
    base.sample(_seeds(n, 12, 0), (3, 2))            # advances base's draws
    again = base.reseeded(11)
    assert again._nbr is base._nbr and again._offsets is base._offsets
    ref = jsampler.NeighborSampler(src, dst, n, seed=11)
    for call in range(2):
        seeds = _seeds(n, 12, call)
        _same(again.sample(seeds, (4,)), ref.sample(seeds, (4,)))


@pytest.mark.parametrize("step", [0, 1, 5])
def test_feeder_draws_equal_a_reference_sampler_with_the_mixed_seed(step):
    """Step s's subgraph: seeds from a generator seeded with the cursor's
    mixed seed, neighbors from a reference sampler on the same arrays with
    the same mixed seed; edge features and labels from the cursor."""
    graph = pipeline.uniform_graph(500, 4_000, seed=2)
    rng = np.random.default_rng(
        DataCursor(2, 0).seed_sequence(pipeline.GRAPH_STREAM))
    src = rng.integers(0, 500, 4_000, dtype=np.int32)
    dst = rng.integers(0, 500, 4_000, dtype=np.int32)
    np.testing.assert_array_equal(graph._nbr,
                                  jsampler.NeighborSampler(src, dst, 500)._nbr)
    cursor = DataCursor(2, step)
    seeds = np.random.default_rng(
        cursor.mixed_seed(pipeline.SEED_STREAM)).choice(500, 64, replace=False)
    assert len(set(seeds.tolist())) == 64
    ref = jsampler.NeighborSampler(
        src, dst, 500, seed=cursor.mixed_seed(pipeline.SAMPLE_STREAM))
    want = ref.sample(seeds, (5, 3))
    _same(pipeline.sample_subgraph(cursor, graph, 64, (5, 3)), want)
    batch = pipeline.gnn_sampled_batch(cursor, graph, 64, (5, 3), 41,
                                       "node_class", device="cpu")
    for k in ("nodes", "node_valid", "src", "dst"):
        np.testing.assert_array_equal(batch[k].numpy(), getattr(want, k))
    assert int(batch["n_seeds"]) == 64 and batch["n_seeds"].dtype == torch.int32
    assert batch["labels"].shape == (64,) and int(batch["labels"].max()) < 41
    again = pipeline.gnn_sampled_batch(cursor, graph, 64, (5, 3), 41,
                                       "node_class", device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    other = pipeline.sample_subgraph(DataCursor(2, step + 1), graph, 64, (5, 3))
    assert not np.array_equal(other.nodes, want.nodes)


def test_shape_graph_is_built_once_per_shape_and_seed(monkeypatch):
    monkeypatch.setitem(gnn_family.GNN_SHAPES, SMALL, dict(SMALL_SHAPE))
    gnn_family.shape_graph.cache_clear()
    try:
        a = gnn_family.shape_graph(SMALL, 0)
        assert gnn_family.shape_graph(SMALL, 0) is a
        assert gnn_family.shape_graph(SMALL, 1) is not a
        want = pipeline.uniform_graph(300, 30_000, 0)
        np.testing.assert_array_equal(a._nbr, want._nbr)
        np.testing.assert_array_equal(a._offsets, want._offsets)
        assert int(a._offsets[-1]) == 30_000
    finally:
        gnn_family.shape_graph.cache_clear()


def test_a_passed_graph_gives_the_shape_graphs_batches(monkeypatch):
    """``shape_batch(..., graph=g)`` samples ``g``: its batches equal those
    of the default call, which samples ``shape_graph`` (the same graph,
    built there), and it builds no graph of its own."""
    monkeypatch.setitem(gnn_family.GNN_SHAPES, SMALL, dict(SMALL_SHAPE))
    tcfg = _small_cfgs("gcn-cora")[0]
    gnn_family.shape_graph.cache_clear()
    try:
        graph = pipeline.uniform_graph(300, 30_000, 0)
        steps = (0, 3)
        passed = [gnn_family.shape_batch(tcfg, SMALL, DataCursor(0, step),
                                         "cpu", graph) for step in steps]
        assert gnn_family.shape_graph.cache_info().misses == 0
        for step, a in zip(steps, passed):
            b = gnn_family.shape_batch(tcfg, SMALL, DataCursor(0, step), "cpu")
            assert a.keys() == b.keys()
            assert all(torch.equal(a[k], b[k]) for k in a)
        assert gnn_family.shape_graph.cache_info().misses == 1
    finally:
        gnn_family.shape_graph.cache_clear()


# -- sampled training against the JAX package --------------------------------


def _small_cfgs(arch):
    """(port cfg, JAX cfg) of ``arch`` reduced, bound to the small shape
    (feature table of 1,024 rows; graphcast's n_vars as its features)."""
    def bind(cfg):
        d_in = cfg.n_vars if cfg.arch == "graphcast" else SMALL_SHAPE["d_feat"]
        d_out, task = 5, ("node_class" if cfg.arch in ("gcn", "pna")
                          else "node_reg")
        if cfg.arch == "graphcast":
            d_out = cfg.n_vars
        return dataclasses.replace(cfg, d_in=d_in, d_out=d_out, task=task,
                                   feature_table=1_024)
    tcfg = bind(tconfigs.reduced_config(arch)[0])
    jcfg = bind(j_reduced_config(arch)[0])
    assert dataclasses.asdict(tcfg) == {
        k: v for k, v in dataclasses.asdict(jcfg).items() if k != "param_dtype"}
    return tcfg, jcfg


def _small_batch(tcfg, monkeypatch, step=0):
    """The small shape's batch, sampled from ``_graph``'s graph (a third of
    its vertices without in-edges) in place of ``shape_graph``'s."""
    monkeypatch.setitem(gnn_family.GNN_SHAPES, SMALL, dict(SMALL_SHAPE))
    src, dst, n = _graph(e=SMALL_SHAPE["n_edges"])
    graph = NeighborSampler(src, dst, n)
    monkeypatch.setattr(gnn_family, "shape_graph", lambda *_: graph)
    return gnn_family.shape_batch(tcfg, SMALL, DataCursor(0, step), "cpu")


def _carried(arch, monkeypatch):
    tcfg, jcfg = _small_cfgs(arch)
    tb = _small_batch(tcfg, monkeypatch)
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    assert tuple(tp["features"].shape) == (1_024, tcfg.d_in)
    np.testing.assert_array_equal(tp["features"].numpy(),
                                  np.asarray(jp["features"]))
    return tcfg, jcfg, tp, jp, tb, jb


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _float64(jcfg, jp, jb):
    """The JAX package's forward and gradients in float64."""
    with jax.enable_x64(True):
        def wide(a):
            a = np.asarray(a)
            return jnp.asarray(a, jnp.float64 if a.dtype == np.float32
                               else a.dtype)
        cfg = dataclasses.replace(jcfg, param_dtype=jnp.float64)
        p64, b64 = jax.tree.map(wide, jp), {k: wide(v) for k, v in jb.items()}
        out = np.asarray(j_forward(cfg, p64, b64))
        grads = jax.grad(lambda p: j_loss(cfg, p, b64))(p64)
        return out, [np.asarray(g) for g in jax.tree.leaves(grads)]


def _as_accurate(got, ref32, exact, tol):
    """``got`` at most ``PNA_ERR_RATIO`` times as far from ``exact`` as
    ``ref32`` is, plus ``tol`` of ``exact``'s largest magnitude."""
    got = got.detach().numpy().astype(np.float64)
    ref32 = np.asarray(ref32, np.float64)
    scale = max(np.abs(exact).max(), 1e-30)
    ref_err = np.abs(ref32 - exact).max()
    assert np.abs(got - exact).max() <= PNA_ERR_RATIO * ref_err + tol * scale


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_sampled_forward_loss_and_gradients_match_jax(arch, monkeypatch):
    tcfg, jcfg, tp, jp, tb, jb = _carried(arch, monkeypatch)
    assert tb["nodes"].shape == (1_024,) and int(tb["n_seeds"]) == 16
    out, jout = gnn_forward(tcfg, tp, tb), j_forward(jcfg, jp, jb)
    lj, gj = jax.value_and_grad(lambda p: j_loss(jcfg, p, jb))(jp)
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    lt = gnn_loss(tcfg, tree_unflatten(tp, leaves), tb)
    _close(lt, lj, FWD_TOL)
    gt = torch.autograd.grad(lt, leaves)
    jleaves = jax.tree.leaves(gj)
    assert len(jleaves) == len(gt)
    if arch == "pna":
        exact_out, exact_grads = _float64(jcfg, jp, jb)
        _as_accurate(out, jout, exact_out, FWD_TOL)
        for g, want, exact in zip(gt, jleaves, exact_grads):
            _as_accurate(g, want, exact, GRAD_TOL)
    else:
        _close(out, jout, FWD_TOL)
        for g, want in zip(gt, jleaves):
            _close(g, want, GRAD_TOL)
    # the table's gradient reaches exactly the rows of valid sampled nodes
    touched = torch.zeros(1_024, dtype=torch.bool)
    touched[tb["nodes"][tb["node_valid"]].long()] = True
    g_table = tree_unflatten(tp, list(gt))["features"]
    assert not bool(g_table[~touched].any())


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_sampled_three_adamw_steps_match_jax(arch, monkeypatch):
    tcfg, jcfg, tp, jp, tb, jb = _carried(arch, monkeypatch)
    jo, to = j_adamw_init(jp), adamw_init(tp)
    for _ in range(3):
        lj, gj = jax.value_and_grad(lambda p: j_loss(jcfg, p, jb))(jp)
        jp, jo, jnorm = j_adamw_update(gj, jo, jp, lr=1e-3, weight_decay=0.0)
        tp, to, lt, tnorm = ttrain.train_step(
            lambda p, b: gnn_loss(tcfg, p, b), tp, to, tb, lr=1e-3)
        _close(lt, lj, FWD_TOL)
        _close(tnorm, jnorm, GRAD_TOL)
    assert int(to.count) == int(jo.count) == 3
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=PARAM_TOL)


def _edge_sets(arch):
    """(dst key, the other keys cut with it) of the grid's sampled edges."""
    if arch == "graphcast":
        return "m2g_dst", ("m2g_src", "m2g_feat", "g2m_src", "g2m_dst",
                           "g2m_feat")
    return "dst", ("src", "edge_feat")


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_sentinel_remap_leaves_real_outputs_unchanged(arch, monkeypatch):
    """At a padding fanout (160 sampled nodes padded to 1,024) the
    sampler's invalid samples get the padded sentinel: the outputs equal
    those of the batch with every sentinel edge removed. Left at the
    sampler's own sentinel n_local (a padded node's id), they would reach
    PNA's degree statistics and change the real outputs."""
    tcfg, _ = _small_cfgs(arch)
    batch = _small_batch(tcfg, monkeypatch)
    n, n_local = batch["nodes"].shape[0], 160
    dst_key, cut = _edge_sets(arch)
    dst = batch[dst_key]
    sampled = 144                                  # 16 * 3 + 48 * 2
    invalid = int((dst[:sampled] == n).sum())
    assert invalid > 0 and int((dst[sampled:] == n).sum()) == 512 - sampled
    assert not bool((dst == n_local).any())
    assert not bool(batch["node_valid"][n_local:].any())
    assert not bool(batch["nodes"][n_local:].any())
    if arch == "graphcast":
        m = batch["mesh_valid"].shape[0]
        assert torch.equal(batch["g2m_dst"] == m, dst == n)
    params = params_from_arrays(jax.tree.map(
        np.asarray, j_init(jax.random.PRNGKey(1), _small_cfgs(arch)[1])), "cpu")
    out = gnn_forward(tcfg, params, batch)
    keep = dst < n
    trimmed = dict(batch, **{k: batch[k][keep] for k in (dst_key,) + cut})
    np.testing.assert_allclose(gnn_forward(tcfg, params, trimmed).numpy(),
                               out.numpy(), rtol=1e-6, atol=1e-6)
    if arch == "pna":
        raw = dict(batch, dst=torch.where(dst == n, n_local, dst))
        moved = gnn_forward(tcfg, params, raw)
        assert not torch.allclose(moved[:n_local], out[:n_local])

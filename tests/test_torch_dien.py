"""The port's DIEN held against the JAX package on the CPU (reduced config:
1,000 items, 50 categories, sequence 10; the published widths otherwise).

Same inputs (the JAX package's batch and weights, carried across as numpy
arrays with ``interop.params_from_arrays``) go through both packages'
forward, loss, gradients, three AdamW steps and candidate scoring. The
pooled history's bag sums are bit-exact against the reference's bag
(``test_torch_embedding_bag``), but the reference's DIEN sums ``beh *
mask`` over the sequence in another order, and its matrix products round
in another order than torch's. The tolerances below are set from that:
logits within 1e-5 of the largest |logit|, the loss within 1e-5 relative,
gradients within 1e-4 of each leaf's largest magnitude (measured: at most
7.9e-6), parameters after three steps of lr 1e-3 within 2e-5 (measured: at
most 8.4e-6).

One leaf is held differently: the attention MLP's output bias. The
attention is a softmax over the sequence, which no constant shift of its
logits changes, so that bias's gradient is 0 in exact arithmetic and both
packages return rounding noise (about 1e-11 against gradients of 0.1):
it is held within 1e-6 of the tree's largest gradient instead. (Adam's
eps keeps that noise's steps near lr * 1e-3.)
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.configs.recsys_family import _abstract_batch  # noqa: E402
from repro.data import DataCursor as JCursor  # noqa: E402
from repro.data import dien_batch as j_dien_batch  # noqa: E402
from repro.models import dien as jdien  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.recsys_family import RECSYS_SHAPES, shape_batch  # noqa: E402
from repro_torch.data import DataCursor, dien_batch  # noqa: E402
from repro_torch.interop import params_from_arrays  # noqa: E402
from repro_torch.kernels import embedding_bag, segment_reduce  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import dien as tdien  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten  # noqa: E402

FWD_TOL, LOSS_TOL, GRAD_TOL, PARAM_TOL = 1e-5, 1e-5, 1e-4, 2e-5
# tree_leaves index of params["att"]["layers"][1]["b"] (keys sorted)
ATT_OUT_BIAS = 2


def _strip(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("param_dtype", "scan_unroll")}


def _carried(batch=8, mask="full"):
    """(JAX cfg, port cfg, JAX params, port params, JAX batch, port batch):
    the reduced config, seed-0 weights and a ``dien_batch``; ``mask="ragged"``
    masks each row's last 0..S-1 steps."""
    jcfg, _ = j_reduced_config("dien")
    tcfg, _ = tconfigs.reduced_config("dien")
    jp = jdien.init_dien_params(jax.random.PRNGKey(0), jcfg)
    jb = dict(j_dien_batch(JCursor(0, 0), batch, jcfg.seq_len, jcfg.n_items,
                           jcfg.n_cats))
    if mask == "ragged":
        keep = np.random.default_rng(3).integers(1, jcfg.seq_len + 1, batch)
        jb["hist_mask"] = jnp.asarray(
            np.arange(jcfg.seq_len)[None, :] < keep[:, None])
    tp = params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    return jcfg, tcfg, jp, tp, jb, tb


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def test_config_registry_and_init_shapes_match_reference():
    tcfg, tfam = tconfigs.get_arch("dien")
    jcfg, jfam = j_get_arch("dien")
    assert tfam == jfam == "recsys"
    assert _strip(tcfg) == _strip(jcfg)
    assert tcfg.d_behavior == jcfg.d_behavior == 36
    assert _strip(tconfigs.reduced_config("dien")[0]) == _strip(
        j_reduced_config("dien")[0])
    small = tconfigs.reduced_config("dien")[0]
    want = jax.tree.map(np.shape, jdien.init_dien_params(
        jax.random.PRNGKey(0), j_reduced_config("dien")[0]))
    params = tdien.init_dien_params(torch.Generator().manual_seed(0), small)
    assert tree_map(lambda t: tuple(t.shape), params) == want
    assert tree_leaves(params)[ATT_OUT_BIAS].shape == (1,)
    assert abs(float(params["item_emb"].std()) - 0.02) < 2e-3


@pytest.mark.parametrize("mask", ["full", "ragged"])
def test_forward_loss_and_gradients_match_jax(mask):
    jcfg, tcfg, jp, tp, jb, tb = _carried(mask=mask)
    jlogits, jstates, jbeh, _ = jdien.dien_forward(jcfg, jp, jb)
    tlogits, tstates, tbeh, _ = tdien.dien_forward(tcfg, tp, tb)
    _close(tlogits, jlogits, FWD_TOL)
    _close(tstates, jstates, FWD_TOL)
    np.testing.assert_array_equal(tbeh.numpy(), np.asarray(jbeh))  # lookups
    lj, gj = jax.value_and_grad(lambda p: jdien.dien_loss(jcfg, p, jb))(jp)
    leaves = [p.requires_grad_() for p in tree_leaves(tp)]
    lt = tdien.dien_loss(tcfg, tree_unflatten(tp, leaves), tb)
    assert _rel(lt.detach(), lj) < LOSS_TOL
    gt = torch.autograd.grad(lt, leaves)
    jleaves = jax.tree.leaves(gj)
    assert len(jleaves) == len(gt)
    biggest = max(float(np.abs(np.asarray(g)).max()) for g in jleaves)
    for i, (g, want) in enumerate(zip(gt, jleaves)):
        if i == ATT_OUT_BIAS:
            assert float(g.abs().max()) < 1e-6 * biggest
            assert float(np.abs(np.asarray(want)).max()) < 1e-6 * biggest
        else:
            _close(g, want, GRAD_TOL)


def test_three_adamw_steps_match_jax():
    jcfg, tcfg, jp, tp, jb, tb = _carried()
    jo, to = j_adamw_init(jp), adamw_init(tp)

    def loss_fn(p, b):
        return tdien.dien_loss(tcfg, p, b)
    for _ in range(3):
        lj, gj = jax.value_and_grad(
            lambda p: jdien.dien_loss(jcfg, p, jb))(jp)
        jp, jo, jnorm = j_adamw_update(gj, jo, jp, lr=1e-3, weight_decay=0.0)
        tp, to, lt, tnorm = ttrain.train_step(loss_fn, tp, to, tb, lr=1e-3)
        assert _rel(lt, lj) < LOSS_TOL
        assert _rel(tnorm, jnorm) < GRAD_TOL
    assert int(to.count) == int(jo.count) == 3
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=PARAM_TOL)


def _retrieval_batch(jb, row, cand_items, cand_cats):
    return {"hist_items": jb["hist_items"][row:row + 1],
            "hist_cats": jb["hist_cats"][row:row + 1],
            "hist_mask": jb["hist_mask"][row:row + 1],
            "cand_items": cand_items, "cand_cats": cand_cats}


def test_score_candidates_match_jax_in_chunks(monkeypatch):
    """Chunks of 7 over 30 candidates (the last one partial) give the
    reference's unchunked scores, within the forward tolerance."""
    jcfg, tcfg, jp, tp, jb, tb = _carried(mask="ragged")
    rng = np.random.default_rng(5)
    items = rng.integers(0, jcfg.n_items, 30).astype(np.int32)
    cats = rng.integers(0, jcfg.n_cats, 30).astype(np.int32)
    want = jdien.dien_score_candidates(
        jcfg, jp, _retrieval_batch(jb, 2, jnp.asarray(items),
                                   jnp.asarray(cats)))
    monkeypatch.setattr(tdien, "CANDIDATE_CHUNK", 7)
    got = tdien.dien_score_candidates(
        tcfg, tp, _retrieval_batch(tb, 2, torch.from_numpy(items),
                                   torch.from_numpy(cats)))
    assert got.shape == (30,)
    _close(got, want, FWD_TOL)


def test_retrieval_equals_forward_margin(monkeypatch):
    """Scoring row r's history against every row's target equals the
    forward's logit margin of a batch holding that history and those
    targets (as ``tests/test_models.py`` checks the reference)."""
    _, tcfg, _, tp, _, tb = _carried(batch=6, mask="ragged")
    monkeypatch.setattr(tdien, "CANDIDATE_CHUNK", 4)
    for row in (0, 3):
        scores = tdien.dien_score_candidates(
            tcfg, tp, _retrieval_batch(tb, row, tb["target_item"],
                                       tb["target_cat"]))
        same = {k: tb[k][row:row + 1].expand(6, -1)
                for k in ("hist_items", "hist_cats", "hist_mask")}
        same.update(target_item=tb["target_item"],
                    target_cat=tb["target_cat"])
        logits, *_ = tdien.dien_forward(tcfg, tp, same)
        _close(scores, logits[:, 1] - logits[:, 0], 1e-5)


def test_pooled_history_runs_in_the_bag_kernel():
    """The forward's pooled history is two embedding_bag calls (item and
    category); a training step also sums gradients in segment_reduce."""
    _, tcfg, _, tp, _, tb = _carried()
    before = embedding_bag.launches, segment_reduce.launches
    tdien.dien_forward(tcfg, tp, tb)
    # on the CPU the wrapper runs the plain version: no launch is counted
    assert (embedding_bag.launches, segment_reduce.launches) == before
    pooled = tdien._pooled_history(tp, tb["hist_items"], tb["hist_cats"],
                                   tb["hist_mask"])
    beh = torch.cat([tp["item_emb"][tb["hist_items"].long()],
                     tp["cat_emb"][tb["hist_cats"].long()]], -1)
    np.testing.assert_allclose(pooled.numpy(), beh.sum(1).numpy(), rtol=0,
                               atol=1e-6)


def test_dien_batch_matches_reference_shapes_and_ranges():
    j = j_dien_batch(JCursor(0, 0), 5, 7, 100, 10)
    t = dien_batch(DataCursor(0, 0), 5, 7, 100, 10, device="cpu")
    assert sorted(t) == sorted(j)
    for k in j:
        assert tuple(t[k].shape) == j[k].shape, k
        assert str(t[k].dtype).removeprefix("torch.") == str(j[k].dtype), k
    assert bool(t["hist_mask"].all())
    for k, high in (("hist_items", 100), ("hist_cats", 10),
                    ("target_item", 100), ("target_cat", 10), ("label", 2)):
        assert int(t[k].min()) >= 0 and int(t[k].max()) < high, k
    assert set(t["label"].tolist()) == {0, 1}
    again = dien_batch(DataCursor(0, 0), 5, 7, 100, 10, device="cpu")
    other = dien_batch(DataCursor(0, 1), 5, 7, 100, 10, device="cpu")
    assert all(torch.equal(t[k], again[k]) for k in t)
    assert not torch.equal(t["hist_items"], other["hist_items"])


@pytest.mark.parametrize("shape_id", sorted(RECSYS_SHAPES))
def test_shape_batch_matches_reference_specs(shape_id):
    """Same keys, shapes and dtypes as ``_abstract_batch`` (the retrieval
    candidates padded to 512 as the reference's cell pads them)."""
    cfg = tconfigs.reduced_config("dien")[0]
    jcfg = j_reduced_config("dien")[0]
    sh = RECSYS_SHAPES[shape_id]
    specs = dict(_abstract_batch(jcfg, sh["batch"],
                                 with_label=sh["kind"] == "train"))
    if sh["kind"] == "retrieval":
        c = ((sh["n_candidates"] + 511) // 512) * 512
        assert c == 1_000_448
        specs["cand_items"] = jax.ShapeDtypeStruct((c,), jnp.int32)
        specs["cand_cats"] = jax.ShapeDtypeStruct((c,), jnp.int32)
    batch = shape_batch(cfg, shape_id, DataCursor(0, 0), "cpu")
    assert sorted(batch) == sorted(specs)
    for k, s in specs.items():
        assert tuple(batch[k].shape) == tuple(s.shape), k
        assert str(batch[k].dtype).removeprefix("torch.") == str(s.dtype), k
    if sh["kind"] == "retrieval":
        assert int(batch["cand_items"].max()) < cfg.n_items
        assert int(batch["cand_cats"].max()) < cfg.n_cats
    small = shape_batch(cfg, shape_id, DataCursor(0, 0), "cpu", batch=3)
    assert small["hist_items"].shape == (3, cfg.seq_len)


def test_dien_run_sets_up_the_run(monkeypatch):
    """``dien_run`` is the shape's seeded batch (train_batch cut to
    ``DIEN_TRAIN_BATCH`` rows), seeded parameters and fresh AdamW state;
    its loss is finite. (Run on the reduced config and a 16-row cut here:
    the full item table is 604 MB.)"""
    small = tconfigs.reduced_config("dien")
    monkeypatch.setattr(ttrain, "get_arch", lambda arch: small)
    monkeypatch.setattr(ttrain, "DIEN_TRAIN_BATCH", 16)
    cfg, batch, params, opt, loss_fn = ttrain.dien_run("train_batch", "cpu",
                                                       seed=2)
    assert cfg == small[0]
    want = shape_batch(cfg, "train_batch", DataCursor(2, 0), "cpu", 16)
    assert sorted(batch) == sorted(want)
    assert all(torch.equal(batch[k], want[k]) for k in want)
    again = tdien.init_dien_params(torch.Generator().manual_seed(2), cfg)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))
    assert int(opt.count) == 0
    assert torch.isfinite(loss_fn(params, batch))
    serve = ttrain.dien_run("serve_p99", "cpu")[1]
    assert serve["hist_items"].shape == (512, cfg.seq_len)
    assert "label" not in serve


def test_train_cli_on_cpu_decreases_loss():
    losses = ttrain.main(["--arch", "dien", "--steps", "4", "--reduced",
                          "--device", "cpu"])
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert all(np.isfinite(losses))

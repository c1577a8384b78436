"""LM training in the port held against the JAX package on the CPU.

``lm_loss``'s gradients for every parameter leaf against
``jax.value_and_grad`` of ``repro.models.transformer.lm_loss`` at the five
reduced configs (float32, the JAX package's seed-0 weights and batches
carried across), ``vocab_chunk`` and ``attn_chunk`` on and off: each leaf
within ``GRAD_TOL`` = 1e-5 of its largest magnitude (measured: at most
1.7e-6), the loss within ``LOSS_TOL`` = 1e-5 relative (measured: at most
2.4e-7). llama4's router gradient is 0 in exact arithmetic (top-1
routing renormalizes the chosen probability to exactly 1); both packages
return rounding noise there (the reference's: 1.6e-9 against a largest
gradient of 1.48), held below ``NOISE_TOL`` = 1e-6 of the largest
gradient of any leaf.

Also: the recompute on and off gives the same loss and
gradients bit for bit; the embedding's and the MoE dispatch's gradient
sums equal ``jax.ops.segment_sum`` and the reference's transposed gathers
bit for bit in float32 and round once in bfloat16 (ROADMAP §C); reduced
stablelm in bfloat16 within ``BF16_GRAD_ULPS`` = 8 bfloat16 ulps of each
leaf's largest magnitude (measured: 3.0); ``adamw_update`` over bfloat16
leaves bit for bit; ``lm_batch``; three ``train_step`` s against the
reference's jitted step; the train CLI for the five LM ids, with a
bfloat16 checkpoint round trip and ``--resume``; and the port's
``examples/torch_train_lm_e2e.py``.
"""

import dataclasses
import math
import pathlib
import runpy

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import DataCursor, lm_batch  # noqa: E402
from repro_torch.interop import params_from_arrays  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.runtime import CheckpointManager  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
LM_ARCHS = ["qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b", "llama3.2-3b",
            "nemotron-4-340b", "stablelm-1.6b"]
GRAD_TOL, LOSS_TOL, NOISE_TOL = 1e-5, 1e-5, 1e-6
BF16_GRAD_ULPS = 8
# zero in exact arithmetic: (arch, leaf path)
NOISE_LEAVES = {("llama4-maverick-400b-a17b", "['moe']['router']")}


def _carried(arch, **changes):
    """(JAX cfg, port cfg, JAX params, port params): the reduced config,
    seed-0 weights of the JAX package carried across."""
    jcfg = dataclasses.replace(j_reduced_config(arch)[0], **changes)
    tchanges = dict(changes)
    if "param_dtype" in tchanges:
        tchanges["param_dtype"] = getattr(
            torch, str(jnp.dtype(changes["param_dtype"])))
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch)[0], **tchanges)
    jp = jtf.init_lm_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_arrays(jax.tree.map(np.asarray, jp),
                                              "cpu")


def _batch(vocab, shape=(2, 32), seed=1):
    toks = np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                       vocab, dtype=jnp.int32))
    labels = np.concatenate([toks[:, 1:], np.full((shape[0], 1), -1,
                                                  np.int32)], 1)
    return toks, labels


def _port_loss_and_grads(tcfg, tp, toks, labels):
    return ttrain.loss_and_grads(
        lambda p, b: ttf.lm_loss(tcfg, p, b[0], b[1]), tp,
        (torch.from_numpy(toks), torch.from_numpy(labels)))


def _no_recompute(fn, *args, **kwargs):
    """``torch.utils.checkpoint.checkpoint`` that keeps the activations."""
    return fn(*args)


def _ref_loss_and_grads(jcfg, jp, toks, labels):
    return jax.value_and_grad(lambda p: jtf.lm_loss(
        jcfg, p, jnp.asarray(toks), jnp.asarray(labels)))(jp)


def _paths(tree):
    return [jax.tree_util.keystr(k)
            for k, _ in jax.tree_util.tree_leaves_with_path(tree)]


def _f64(a):
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(t)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _bf16_ulp(v):
    e = np.floor(np.log2(np.maximum(np.abs(np.asarray(v, np.float64)),
                                    2.0 ** -126)))
    return 2.0 ** (e - 7)


# -- gradients -------------------------------------------------------------

@pytest.mark.parametrize("attn_chunk", [0, 8])
@pytest.mark.parametrize("vocab_chunk", [0, 8])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_gradients_match_reference(arch, vocab_chunk, attn_chunk):
    jcfg, tcfg, jp, tp = _carried(arch, vocab_chunk=vocab_chunk,
                                  attn_chunk=attn_chunk)
    toks, labels = _batch(jcfg.vocab)
    jl, jg = _ref_loss_and_grads(jcfg, jp, toks, labels)
    tl, tg = _port_loss_and_grads(tcfg, tp, toks, labels)
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(tl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    largest = max(np.abs(_f64(g)).max() for g in jax.tree.leaves(jg))
    for path, got, want in zip(_paths(jg), tree_leaves(tg),
                               jax.tree.leaves(jg)):
        got, want = _f64(got), _f64(want)
        assert got.shape == want.shape, path
        if (arch, path) in NOISE_LEAVES:
            assert np.abs(got).max() <= NOISE_TOL * largest, path
            assert np.abs(want).max() <= NOISE_TOL * largest, path
            continue
        np.testing.assert_allclose(got, want, rtol=0, err_msg=path,
                                   atol=GRAD_TOL * np.abs(want).max())


@pytest.mark.parametrize("arch,chunks", [(a, 0) for a in LM_ARCHS]
                         + [("qwen3-moe-30b-a3b", 8)])
def test_recompute_on_and_off_equal_bit_for_bit(arch, chunks, monkeypatch):
    """The recompute keeps only each layer's input and runs the layer
    again in the backward: routing, capacity positions and every layout
    are built anew there, and the loss and every gradient equal a run that
    keeps the activations (``checkpoint`` replaced by a plain call), bit
    for bit."""
    cfg = dataclasses.replace(tconfigs.reduced_config(arch)[0],
                              vocab_chunk=chunks, attn_chunk=chunks,
                              capacity_factor=1.0)
    params = ttf.init_lm_params(torch.Generator().manual_seed(0), cfg)
    toks, labels = _batch(cfg.vocab)
    on = _port_loss_and_grads(cfg, params, toks, labels)
    monkeypatch.setattr(ttf, "checkpoint", _no_recompute)
    off = _port_loss_and_grads(cfg, params, toks, labels)
    assert torch.equal(on[0], off[0])
    for a, b in zip(tree_leaves(on[1]), tree_leaves(off[1])):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_recompute_runs_each_layer_again(monkeypatch):
    """With a gradient recorded each layer routes twice (the forward and
    its recomputation in the backward), once without the recompute, and
    once under ``no_grad`` (no checkpoint)."""
    cfg = tconfigs.reduced_config("qwen3-moe-30b-a3b")[0]
    params = ttf.init_lm_params(torch.Generator().manual_seed(0), cfg)
    toks, labels = _batch(cfg.vocab)
    calls = []
    route = ttf._route

    def counted(*a):
        calls.append(1)
        return route(*a)
    monkeypatch.setattr(ttf, "_route", counted)
    counts = []
    for recompute in (ttf.checkpoint, _no_recompute):
        monkeypatch.setattr(ttf, "checkpoint", recompute)
        calls.clear()
        _port_loss_and_grads(cfg, params, toks, labels)
        counts.append(len(calls))
    calls.clear()
    with torch.no_grad():
        ttf.lm_loss(cfg, params, torch.from_numpy(toks),
                    torch.from_numpy(labels))
    counts.append(len(calls))
    assert counts == [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers]


def test_cross_entropy_gradient_equals_autograd_bit_for_bit():
    """``softmax_cross_entropy`` (its gradient formed in one tensor of the
    logits' size) gives the loss and autograd's gradient of the plain
    operations (``logsumexp`` less the label's logit, the masked mean) bit
    for bit, masked labels included."""
    from repro_torch.models.common import softmax_cross_entropy

    def plain(x, labels):
        lse = torch.logsumexp(x, dim=-1)
        ll = torch.take_along_dim(x, labels.clamp(min=0).long()[..., None],
                                  dim=-1)[..., 0]
        mask = labels >= 0
        nll = torch.where(mask, lse - ll, torch.zeros(()))
        return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1)
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((3, 7, 50), generator=gen) * 3
    labels = torch.randint(-1, 50, (3, 7), generator=gen, dtype=torch.int32)
    labels[0] = -1
    got, want = (logits.clone().requires_grad_() for _ in range(2))
    lg, lw = softmax_cross_entropy(got, labels), plain(want, labels)
    assert torch.equal(lg, lw)
    (gg,), (gw,) = (torch.autograd.grad(lg, got),
                    torch.autograd.grad(lw, want))
    np.testing.assert_array_equal(_bits(gg), _bits(gw))
    assert not bool(gg[0].any())                      # a masked row


# -- the two gathers' gradient sums -----------------------------------------

def _embedding_case(dtype, seed=3):
    rng = np.random.default_rng(seed)
    vocab, d, n = 40, 16, 300
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    tokens = rng.integers(0, vocab // 2, n).astype(np.int32)  # skewed
    ct = rng.standard_normal((n, d)).astype(np.float32)
    ct[:5, 0] = -0.0
    return (jnp.asarray(table).astype(dtype), tokens,
            jnp.asarray(ct).astype(dtype))


def _port_embedding_grad(table, tokens, ct):
    t = params_from_arrays(np.asarray(table), "cpu").requires_grad_()
    rows = ttf._embed(t, torch.from_numpy(tokens))
    (g,) = torch.autograd.grad(rows, t, params_from_arrays(np.asarray(ct),
                                                           "cpu"))
    return g


def _ref_embedding_grad(table, tokens, ct):
    return jax.vjp(lambda t: t[jnp.asarray(tokens)], table)[1](ct)[0]


def test_embedding_gradient_float32_equals_segment_sum_bit_for_bit():
    table, tokens, ct = _embedding_case(jnp.float32)
    got = _port_embedding_grad(table, tokens, ct)
    np.testing.assert_array_equal(
        _bits(got), _bits(jax.ops.segment_sum(ct, tokens, table.shape[0])))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_ref_embedding_grad(table, tokens,
                                                            ct)))


def test_embedding_gradient_bfloat16_rounds_once():
    """Pinned difference by design (ROADMAP §C): the port widens the
    bfloat16 row gradients, sums them in float32 and rounds once; the
    reference's bfloat16 scatter-add rounds every partial sum."""
    table, tokens, ct = _embedding_case(jnp.bfloat16)
    got = _port_embedding_grad(table, tokens, ct)
    assert got.dtype == torch.bfloat16
    once = jax.ops.segment_sum(ct.astype(jnp.float32), tokens,
                               table.shape[0]).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(got), _bits(once))
    per_sum = _ref_embedding_grad(table, tokens, ct)
    assert (_bits(got) != _bits(per_sum)).any()
    # up to 22 terms a row: within a few ulps of the largest sum
    # (measured: 2)
    diff = np.abs(_f64(got) - _f64(per_sum)).max()
    assert diff <= 8 * _bf16_ulp(np.abs(_f64(per_sum)).max())


def _dispatch_case(dtype, seed=5):
    """One MoE layer's slot space with drops: the reduced qwen3 config
    with top-4 of 8 experts (up to 4 slots a token) at capacity factor
    1.0, routed by the reference, on 2 groups."""
    changes = dict(capacity_factor=1.0, n_experts=8, top_k=4)
    jcfg = dataclasses.replace(j_reduced_config("qwen3-moe-30b-a3b")[0],
                               **changes)
    jlp = jax.tree.map(lambda a: a[0], jtf.init_lm_params(
        jax.random.PRNGKey(0), jcfg)["moe"])
    rng = np.random.default_rng(seed)
    xg = rng.standard_normal((2, 16, 64)).astype(np.float32)
    xg[0, 0, :3] = -0.0
    top_i = jax.lax.top_k(jnp.einsum("gtd,de->gte", xg, jlp["router"]),
                          jcfg.top_k)[1]
    tcfg = dataclasses.replace(tconfigs.reduced_config(
        "qwen3-moe-30b-a3b")[0], **changes)
    flat_i = torch.from_numpy(np.array(top_i, np.int64)).reshape(2, -1)
    e, k, g_sz = tcfg.n_experts, tcfg.top_k, 16
    cap = max(int(math.ceil(k * g_sz / e)), k)
    pos = ttf._capacity_positions(flat_i)
    slot_safe = torch.where(pos < cap, flat_i * cap + pos.clamp(max=cap - 1),
                            e * cap)
    token_id = torch.arange(g_sz).repeat_interleave(k).expand(2, -1)
    slot_token = ttf._scatter_drop(2, e * cap, slot_safe, token_id)
    slot_valid = ttf._scatter_drop(2, e * cap, slot_safe,
                                   torch.ones_like(slot_safe, dtype=bool))
    assert not bool(slot_valid.all())                # empty slots
    assert int((pos >= cap).sum()) > 0               # dropped choices
    ct = rng.standard_normal((2, e * cap, 64)).astype(np.float32)
    return (jnp.asarray(xg).astype(dtype), slot_token, slot_valid,
            jnp.asarray(ct).astype(dtype))


def _port_dispatch_grad(xg, slot_token, slot_valid, ct):
    x = params_from_arrays(np.asarray(xg), "cpu").requires_grad_()
    xe = ttf._dispatch(x, slot_token, slot_valid)
    (g,) = torch.autograd.grad(xe, x, params_from_arrays(np.asarray(ct),
                                                         "cpu"))
    return g


def _ref_dispatch_grad(xg, slot_token, slot_valid, ct):
    """The reference's dispatch (``repro/models/transformer.py``
    ``_moe_ffn``: a take per group, times the slot's validity),
    transposed."""
    st = jnp.asarray(slot_token.numpy().astype(np.int32))
    sv = jnp.asarray(slot_valid.numpy())

    def dispatch(x):
        xe = jax.vmap(jnp.take, in_axes=(0, 0, None))(x, st, 0)
        return xe * sv[..., None].astype(xe.dtype)
    return jax.vjp(dispatch, xg)[1](ct)[0]


def test_dispatch_gradient_float32_equals_reference_bit_for_bit():
    xg, slot_token, slot_valid, ct = _dispatch_case(jnp.float32)
    got = _port_dispatch_grad(xg, slot_token, slot_valid, ct)
    np.testing.assert_array_equal(
        _bits(got), _bits(_ref_dispatch_grad(xg, slot_token, slot_valid,
                                             ct)))
    g_sz = xg.shape[1]
    ids = (slot_token + torch.arange(2)[:, None] * g_sz).numpy()
    rows = np.asarray(ct) * slot_valid.numpy()[..., None]
    want = jax.ops.segment_sum(rows.reshape(-1, ct.shape[-1]),
                               ids.reshape(-1).astype(np.int32), 2 * g_sz)
    np.testing.assert_array_equal(_bits(got).reshape(-1, ct.shape[-1]),
                                  _bits(want))


def test_dispatch_gradient_bfloat16_rounds_once():
    """Pinned difference by design (ROADMAP §C), as for the embedding."""
    xg, slot_token, slot_valid, ct = _dispatch_case(jnp.bfloat16)
    got = _port_dispatch_grad(xg, slot_token, slot_valid, ct)
    assert got.dtype == torch.bfloat16
    g_sz, d = xg.shape[1:]
    ids = (slot_token + torch.arange(2)[:, None] * g_sz).numpy().reshape(-1)
    rows = (ct.astype(jnp.float32) * slot_valid.numpy()[..., None])
    once = jax.ops.segment_sum(rows.reshape(-1, d), ids.astype(np.int32),
                               2 * g_sz).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(got).reshape(-1, d), _bits(once))
    per_sum = _ref_dispatch_grad(xg, slot_token, slot_valid, ct)
    assert (_bits(got) != _bits(per_sum)).any()
    # at most 4 slots a token: within an ulp of the largest (measured: 1)
    diff = np.abs(_f64(got) - _f64(per_sum)).max()
    assert diff <= 2 * _bf16_ulp(np.abs(_f64(per_sum)).max())


# -- bfloat16, AdamW, lm_batch ----------------------------------------------

def test_bfloat16_stablelm_gradients_match_reference():
    """Reduced stablelm in bfloat16 (the JAX package's bfloat16 MoE
    einsums do not run on this CPU, so a dense config): the loss within a
    bfloat16 ulp, each gradient leaf bfloat16 and within
    ``BF16_GRAD_ULPS`` of its largest magnitude."""
    jcfg, tcfg, jp, tp = _carried("stablelm-1.6b", param_dtype=jnp.bfloat16)
    toks, labels = _batch(jcfg.vocab)
    jl, jg = _ref_loss_and_grads(jcfg, jp, toks, labels)
    tl, tg = _port_loss_and_grads(tcfg, tp, toks, labels)
    assert abs(float(tl) - float(jl)) <= _bf16_ulp(float(jl))
    for path, got, want in zip(_paths(jg), tree_leaves(tg),
                               jax.tree.leaves(jg)):
        assert got.dtype == torch.bfloat16, path
        got, want = _f64(got), _f64(want)
        worst = np.abs(got - want).max() / _bf16_ulp(np.abs(want).max())
        assert worst <= BF16_GRAD_ULPS, (path, worst)


def _adamw_case(rng, scale):
    return {"w": jnp.asarray(rng.standard_normal((64, 33)) * scale,
                             jnp.bfloat16),
            "s": [jnp.asarray(rng.standard_normal((7,)) * scale,
                              jnp.bfloat16)],
            "r": jnp.asarray(rng.standard_normal((5, 3)) * scale,
                             jnp.float32)}


def test_adamw_bfloat16_leaves_match_reference():
    """Five steps over bfloat16 (and float32) leaves with decay: the four
    below the clip give the reference's new parameters, ``m`` and ``v``
    bit for bit; after the last, whose gradient norm clips (the two
    packages' norms round differently in the last bit), each bfloat16
    parameter is within one ulp of its own value and every other leaf
    within 1e-6 of its largest magnitude."""
    rng = np.random.default_rng(0)
    jp = _adamw_case(rng, 1.0)
    tp = params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    jo, to = j_adamw_init(jp), adamw_init(tp)
    assert {t.dtype for t in tree_leaves(to.m)} == {torch.float32}
    for step, scale in enumerate([0.01, 0.02, 0.01, 0.01, 30.0]):
        g = _adamw_case(rng, scale)
        jp, jo, jn = j_adamw_update(g, jo, jp, lr=1e-3, weight_decay=0.1)
        tp, to, tn = adamw_update(params_from_arrays(
            jax.tree.map(np.asarray, g), "cpu"), to, tp, lr=1e-3,
            weight_decay=0.1)
        assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
        assert int(to.count) == step + 1
        pairs = [(tree_leaves(tp), jax.tree.leaves(jp)),
                 (tree_leaves(to.m), jax.tree.leaves(jo.m)),
                 (tree_leaves(to.v), jax.tree.leaves(jo.v))]
        for got, want in zip(*map(sum, zip(*pairs), ([], []))):
            assert got.dtype == getattr(torch, str(want.dtype))
            if scale < 1:
                np.testing.assert_array_equal(_bits(got), _bits(want))
            else:
                w = _f64(want)
                unit = (_bf16_ulp(w) if got.dtype == torch.bfloat16
                        else 1e-6 * np.abs(w).max())
                assert (np.abs(_f64(got) - w) <= unit).all()


def test_lm_batch_is_a_next_token_shift_of_seed_and_step():
    b = lm_batch(DataCursor(3, 5), 4, 64, 1000, device="cpu")
    toks, labels = b["tokens"], b["labels"]
    assert toks.dtype == labels.dtype == torch.int32
    assert tuple(toks.shape) == tuple(labels.shape) == (4, 64)
    assert int(toks.min()) >= 0 and int(toks.max()) < 1000
    assert torch.equal(labels[:, :-1], toks[:, 1:])
    assert bool((labels[:, -1] == -1).all())
    again = lm_batch(DataCursor(3, 5), 4, 64, 1000, device="cpu")
    assert torch.equal(again["tokens"], toks)
    for other in (DataCursor(3, 6), DataCursor(4, 5)):
        assert not torch.equal(lm_batch(other, 4, 64, 1000,
                                        device="cpu")["tokens"], toks)
    assert len(set(toks.flatten().tolist())) > 200      # not constant


# -- training runs ----------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-moe-30b-a3b"])
def test_train_steps_match_reference_jitted_step(arch):
    """Three steps of ``train_step`` against the reference CLI's jitted
    step (``value_and_grad`` then ``adamw_update`` at lr 1e-3, decay 0)
    on the same weights and batch: every step's loss within 1e-5 relative
    (measured: 4.5e-7). Adam's first steps are about lr times the
    gradient's sign, so where a gradient is small against its rounding an
    element may step otherwise: every element of the final parameters
    within 2 x 3 x lr of the reference's, and all but 1 in 10^4 of each
    leaf's within 1e-4 of its largest magnitude (measured: one element of
    qwen3's expert w_up at 1.2e-4, the rest at most 8.3e-5)."""
    jcfg, tcfg, jp, tp = _carried(arch)
    toks, labels = _batch(jcfg.vocab, (4, 16))

    @jax.jit
    def step(params, opt):
        loss, grads = jax.value_and_grad(lambda p: jtf.lm_loss(
            jcfg, p, jnp.asarray(toks), jnp.asarray(labels)))(params)
        new_p, new_o, _ = j_adamw_update(grads, opt, params, lr=1e-3,
                                         weight_decay=0.0)
        return new_p, new_o, loss

    def loss_fn(p, b):
        return ttf.lm_loss(tcfg, p, b["tokens"], b["labels"])
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)}
    jo, to = j_adamw_init(jp), adamw_init(tp)
    for _ in range(3):
        jp, jo, jl = step(jp, jo)
        tp, to, tl, _ = ttrain.train_step(loss_fn, tp, to, batch, lr=1e-3)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    for path, got, want in zip(_paths(jp), tree_leaves(tp),
                               jax.tree.leaves(jp)):
        w = _f64(want)
        diff = np.abs(_f64(got) - w)
        assert diff.max() <= 2 * 3 * 1e-3, path
        assert (diff > 1e-4 * np.abs(w).max()).mean() <= 1e-4, path


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_train_cli_lm_reduced_loss_falls(arch, capsys):
    losses = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--steps", "4"])
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert all(math.isfinite(x) for x in losses)
    assert f"[train] {arch} step 4 loss " in capsys.readouterr().out


def test_train_cli_checkpoint_and_resume(tmp_path, capsys):
    """``--ckpt-dir``/``--resume``: a run stopped after 4 steps and resumed
    to 6 takes the same last two steps as a straight 6-step run."""
    args = ["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu",
            "--ckpt-every", "2"]
    straight = ttrain.main(args + ["--steps", "6"])
    ttrain.main(args + ["--steps", "4", "--ckpt-dir", str(tmp_path)])
    assert CheckpointManager(str(tmp_path), device="cpu").latest_step() == 4
    resumed = ttrain.main(args + ["--steps", "6", "--ckpt-dir",
                                  str(tmp_path), "--resume"])
    assert "[train] resumed at step 4" in capsys.readouterr().out
    assert resumed == straight[4:]


def test_checkpoint_round_trips_a_bfloat16_lm(tmp_path):
    """A bfloat16 LM's parameters, its AdamW state after one step and the
    data cursor come back with the same dtypes and bits."""
    cfg = dataclasses.replace(tconfigs.reduced_config("qwen3-moe-30b-a3b")[0],
                              param_dtype=torch.bfloat16)
    params = ttf.init_lm_params(torch.Generator().manual_seed(0), cfg)
    batch = lm_batch(DataCursor(0, 0), 2, 16, cfg.vocab, device="cpu")
    params, opt, _, _ = ttrain.train_step(
        lambda p, b: ttf.lm_loss(cfg, p, b["tokens"], b["labels"]), params,
        adamw_init(params), batch, lr=1e-3)
    dtypes = {t.dtype for t in tree_leaves(params)}
    assert dtypes == {torch.bfloat16, torch.float32}      # router float32
    state = {"params": params, "opt": opt, "cursor": DataCursor(0, 1)}
    CheckpointManager(str(tmp_path), device="cpu").save(1, state)
    back = CheckpointManager(str(tmp_path), device="cpu").restore_latest()
    assert back["cursor"] == DataCursor(0, 1)
    assert int(back["opt"].count) == 1
    for key in ("params", "opt"):
        for a, b in zip(tree_leaves(back[key]), tree_leaves(state[key])):
            assert a.dtype == b.dtype and a.device.type == "cpu"
            np.testing.assert_array_equal(_bits(a) if a.dim() else a.numpy(),
                                          _bits(b) if b.dim() else b.numpy())


def test_torch_train_lm_e2e_example(tmp_path, capsys):
    example = runpy.run_path(str(REPO / "examples" /
                                 "torch_train_lm_e2e.py"))
    out = example["main"](["--steps", "2", "--batch", "2", "--seq", "32",
                           "--device", "cpu", "--ckpt-dir", str(tmp_path),
                           "--ckpt-every", "2"])
    assert len(out["losses"]) == 2
    assert all(math.isfinite(x) for x in out["losses"])
    text = capsys.readouterr().out
    assert "[e2e] qwen3-family-100m: 108.3M params on cpu" in text
    back = CheckpointManager(str(tmp_path), device="cpu").restore_latest()
    assert back["cursor"] == out["cursor"] == DataCursor(0, 2)
    for key in ("params", "opt"):
        for a, b in zip(tree_leaves(back[key]), tree_leaves(out[key])):
            assert torch.equal(a, b)
    assert tree_map(lambda t: t.dtype, back["params"]) == tree_map(
        lambda t: t.dtype, out["params"])

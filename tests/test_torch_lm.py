"""The port's LM family held against the JAX package on the CPU.

The five LM configs at their reduced size (2 layers, width 64, 4 heads,
vocab 256, float32; ``reduced_lm_config``) with the JAX package's weights
carried across (``interop.params_from_arrays``): ``lm_forward``,
``lm_prefill`` (logits and cache), ``lm_loss`` with ``vocab_chunk`` and
``attn_chunk`` on and off, a prefill followed by four ``lm_decode_step`` s,
and the serve loop's greedy tokens against the reference's ``--arch``
loop. Matrix products sum in another order in XLA's CPU dots than in
torch's, so float32 values are held within ``FWD_TOL`` = 1e-5 of the
tensor's largest magnitude (measured: at most 1.1e-6) and losses within
``LOSS_TOL`` = 1e-5 relative (measured: at most 8.2e-8).

The parts: ``rms_norm``, ``_rope``, ``swiglu`` and ``squared_relu_ffn``;
``_moe_ffn`` at capacity factors 1.0 and 1.25, where tokens drop (the
routing and the kept/dropped (token, choice) pairs equal exactly); top-k
ties (the lower expert first, as ``jax.lax.top_k``); the combine in
float32 bit for bit against ``jax.ops.segment_sum``, and in bfloat16
pinned to one rounding of the float32 sum (the reference's bfloat16
``segment_sum`` rounds every partial sum: ROADMAP §C). One reduced config
in bfloat16 (stablelm: the JAX package's bfloat16 MoE einsums do not run
on XLA's CPU backend, whose dot has no batched BF16 x BF16 = F32 form): hidden
states and logits within ``BF16_ULPS`` = 4 bfloat16 ulps of their largest
magnitude (measured: 2.5 and 1.96 — one float32 sum rounding to the other
side of a bfloat16 tie in ``rms_norm`` spreads through the next
projection).

Also: meta-device parameter shapes, dtypes and ``param_count`` of the
five full configs against ``jax.eval_shape``; decode against forward in
the port; the serve and train CLIs; the bfloat16 ``interop`` round trip.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.configs import reduced_config as j_reduced_config  # noqa: E402
from repro.configs.lm_family import LM_SHAPES as J_LM_SHAPES  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.lm_family import LM_SHAPES  # noqa: E402
from repro_torch.interop import params_from_arrays  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

LM_ARCHS = ["qwen3-moe-30b-a3b", "llama4-maverick-400b-a17b", "llama3.2-3b",
            "nemotron-4-340b", "stablelm-1.6b"]
MOE_ARCHS = LM_ARCHS[:2]
FWD_TOL, LOSS_TOL = 1e-5, 1e-5
BF16_ULPS = 4
# decode's logits against the forward's at the same position, in the port
# (the reference's own test_lm_decode_matches_forward holds 5e-4)
DECODE_TOL = 1e-5


def _strip(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("param_dtype", "scan_unroll", "expert_zero1")}


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def _carried(arch, **changes):
    """(JAX cfg, port cfg, JAX params, port params) at the reduced size,
    seed-0 weights of the JAX package carried across."""
    jcfg = dataclasses.replace(j_reduced_config(arch)[0], **changes)
    tchanges = dict(changes)
    if "param_dtype" in tchanges:
        tchanges["param_dtype"] = getattr(torch, _dtype_name(
            jnp.dtype(changes["param_dtype"])))
    tcfg = dataclasses.replace(tconfigs.reduced_config(arch)[0], **tchanges)
    jp = jtf.init_lm_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_arrays(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(vocab, shape, seed=1):
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                       vocab, dtype=jnp.int32))


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def _bf16_ulp(v) -> np.ndarray:
    """The bfloat16 spacing at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(np.asarray(v, np.float64)),
                                    2.0 ** -126)))
    return 2.0 ** (e - 7)


def _within_ulps(got, want, ulps, *, of_max: bool):
    """|got - want| within ``ulps`` bfloat16 ulps: of the largest |want|
    (``of_max``) or of each element's own |want|."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape
    diff = np.abs(got - want)
    unit = _bf16_ulp(np.abs(want).max()) if of_max else _bf16_ulp(want)
    worst = float((diff / unit).max())
    assert worst <= ulps, worst
    return worst


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(t)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# -- configs and parameters ------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_and_reduced_config_match_reference(arch):
    tcfg, tfam = tconfigs.get_arch(arch)
    jcfg, jfam = j_get_arch(arch)
    assert tfam == jfam == "lm"
    assert _strip(tcfg) == _strip(jcfg)
    assert _dtype_name(tcfg.param_dtype) == jnp.dtype(jcfg.param_dtype).name
    tred, jred = tconfigs.reduced_config(arch)[0], j_reduced_config(arch)[0]
    assert _strip(tred) == _strip(jred)
    assert tred.param_dtype == torch.float32
    assert tcfg.layer_kinds() == jcfg.layer_kinds()
    assert LM_SHAPES == J_LM_SHAPES


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_meta_params_match_reference_eval_shape(arch):
    """The full config's tree on the meta device: every leaf's shape and
    dtype as ``jax.eval_shape(init_lm_params)``'s, and ``param_count``."""
    tcfg, jcfg = tconfigs.get_arch(arch)[0], j_get_arch(arch)[0]
    want = jax.eval_shape(lambda: jtf.init_lm_params(jax.random.PRNGKey(0),
                                                      jcfg))
    got = ttf.init_lm_params(None, tcfg, device="meta")
    assert tree_map(lambda t: (tuple(t.shape), _dtype_name(t.dtype)),
                    got) == jax.tree.map(lambda s: (s.shape, s.dtype.name),
                                         want)
    assert all(t.device.type == "meta" for t in tree_leaves(got))
    assert tcfg.param_count() == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(want))


def test_init_draws_seeded_materialized_weights():
    """Same generator seed, same weights; the attention and dense-FFN
    stacks are one draw repeated over the layers, each copy its own
    memory; the scales are the reference's."""
    cfg = dataclasses.replace(tconfigs.reduced_config("llama4-maverick-"
                                                      "400b-a17b")[0],
                              n_layers=4)
    a = ttf.init_lm_params(torch.Generator().manual_seed(3), cfg)
    b = ttf.init_lm_params(torch.Generator().manual_seed(3), cfg)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    wq = a["attn"]["wq"]
    assert torch.equal(wq[0], wq[3])
    assert wq[0].data_ptr() != wq[3].data_ptr()
    assert a["moe"]["router"].dtype == torch.float32
    assert not torch.equal(a["moe"]["w_up"][0, 0], a["moe"]["w_up"][0, 1])
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    assert abs(float(a["lm_head"].std()) - 64 ** -0.5) < 0.02


# -- the parts -------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_and_ffns_match_reference(dtype):
    """float32 within FWD_TOL; bfloat16 (cast back as the reference does)
    within 1 ulp of each element (rms_norm, _rope) and of the largest
    output (the FFNs)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 16, 64)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    w1, w2 = (rng.standard_normal((2, 64, 128)) / 8).astype(np.float32)
    w3 = (rng.standard_normal((128, 64)) / 11).astype(np.float32)

    def j(a):
        return jnp.asarray(a).astype(dtype)

    def t(a):
        return params_from_arrays(np.asarray(j(a)), "cpu")
    xr = x.reshape(4, 16, 4, 16)
    pos = np.arange(16)[None].repeat(4, 0) * 37     # [B, S] positions
    cases = [
        ("rms_norm", tcommon.rms_norm(t(x), t(gamma)),
         jcommon.rms_norm(j(x), j(gamma)), False),
        ("rope", ttf._rope(t(xr), torch.from_numpy(pos), 10_000.0),
         jtf._rope(j(xr), jnp.asarray(pos), 10_000.0), False),
        ("swiglu", tcommon.swiglu(t(x), t(w1), t(w2), t(w3)),
         jcommon.swiglu(j(x), j(w1), j(w2), j(w3)), True),
        ("squared_relu", tcommon.squared_relu_ffn(t(x), t(w1), t(w3)),
         jcommon.squared_relu_ffn(j(x), j(w1), j(w3)), True),
    ]
    for name, got, want, of_max in cases:
        assert _dtype_name(got.dtype) == jnp.dtype(want.dtype).name, name
        if dtype == "float32":
            _close(got, want, FWD_TOL)
        else:
            _within_ulps(got, want, 1, of_max=of_max)


def _moe_inputs(arch, capacity_factor, seed=5):
    jcfg, tcfg, jp, tp = _carried(arch, capacity_factor=capacity_factor)
    x = np.random.default_rng(seed).standard_normal((2, 16, 64)).astype(
        np.float32)
    jlp = jax.tree.map(lambda a: a[0], jp["moe"])
    tlp = tree_map(lambda a: a[0], tp["moe"])
    return jcfg, tcfg, jlp, tlp, x


def _reference_routing(jcfg, jlp, xg):
    """The reference's routing and capacity positions, its own steps
    (``repro/models/transformer.py`` ``_moe_ffn``, lines 286-305)."""
    logits = jnp.einsum("gtd,de->gte", xg, jlp["router"],
                        preferred_element_type=jnp.float32)
    top_p, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                 jcfg.top_k)
    top_p = top_p / jnp.maximum(jnp.sum(top_p, -1, keepdims=True), 1e-9)
    n_groups, g_sz = xg.shape[:2]
    flat_i = top_i.reshape(n_groups, g_sz * jcfg.top_k)

    def _positions(fi):
        order = jnp.argsort(fi, stable=True)
        se = fi[order]
        run_start = jnp.searchsorted(se, se, side="left")
        pos_sorted = (jnp.arange(fi.shape[0], dtype=jnp.int32)
                      - run_start.astype(jnp.int32))
        return jnp.zeros_like(fi).at[order].set(pos_sorted)
    return top_p, top_i, jax.vmap(_positions)(flat_i)


@pytest.mark.parametrize("arch,capacity_factor,n_groups", [
    ("qwen3-moe-30b-a3b", 1.0, 1), ("qwen3-moe-30b-a3b", 1.25, 1),
    ("qwen3-moe-30b-a3b", 1.0, 2), ("llama4-maverick-400b-a17b", 1.0, 1),
    ("llama4-maverick-400b-a17b", 1.25, 2)])
def test_moe_ffn_with_drops_matches_reference(arch, capacity_factor,
                                              n_groups):
    """The same experts chosen, the same (token, choice) pairs kept and
    dropped, and the output within FWD_TOL."""
    jcfg, tcfg, jlp, tlp, x = _moe_inputs(arch, capacity_factor)
    g_sz = x.shape[0] * x.shape[1] // n_groups
    xg = x.reshape(n_groups, g_sz, -1)
    cap = max(int(np.ceil(jcfg.top_k * g_sz / jcfg.n_experts
                          * capacity_factor)), jcfg.top_k)
    j_top_p, j_top_i, j_pos = _reference_routing(jcfg, jlp, jnp.asarray(xg))
    t_top_p, t_top_i = ttf._route(tcfg, tlp, torch.from_numpy(xg))
    np.testing.assert_array_equal(t_top_i.numpy(), np.asarray(j_top_i))
    _close(t_top_p, j_top_p, FWD_TOL)
    t_pos = ttf._capacity_positions(t_top_i.reshape(n_groups, -1))
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(j_pos))
    kept = np.asarray(j_pos) < cap
    if arch.startswith("qwen3") and capacity_factor == 1.0:
        assert not kept.all()                   # tokens do drop here
    got = ttf._moe_ffn(tcfg, tlp, torch.from_numpy(x), n_groups)
    _close(got, jtf._moe_ffn(jcfg, jlp, jnp.asarray(x), n_groups), FWD_TOL)


def test_top_k_ties_take_the_lower_index_first():
    x = np.random.default_rng(2).integers(0, 3, (64, 16)).astype(np.float32)
    for k in (1, 2, 8, 16):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = ttf._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_under_forced_ties_matches_reference(arch):
    """A zero router ties every expert: both packages route every token to
    experts 0..k-1, keep the first ``cap`` tokens in token order and drop
    the rest (a dropped token's output is the shared expert's, or 0)."""
    jcfg, tcfg, jlp, tlp, x = _moe_inputs(arch, 1.25)
    jlp = dict(jlp, router=jnp.zeros_like(jlp["router"]))
    tlp = dict(tlp, router=torch.zeros_like(tlp["router"]))
    t_top_p, t_top_i = ttf._route(tcfg, tlp, torch.from_numpy(
        x.reshape(1, 32, 64)))
    assert (t_top_i == torch.arange(tcfg.top_k)).all()
    got = ttf._moe_ffn(tcfg, tlp, torch.from_numpy(x), 1)
    want = jtf._moe_ffn(jcfg, jlp, jnp.asarray(x), 1)
    _close(got, want, FWD_TOL)
    cap = max(int(np.ceil(tcfg.top_k * 32 / tcfg.n_experts * 1.25)),
              tcfg.top_k)
    if not tcfg.n_shared_experts:
        assert cap < 32
        assert not bool(got.reshape(32, 64)[cap:].any())
        assert bool(got.reshape(32, 64)[:cap].any())


def _slot_space(n_groups, g_sz, slots, d, dtype, seed=7):
    rng = np.random.default_rng(seed)
    yflat = rng.standard_normal((n_groups, slots, d)).astype(np.float32)
    yflat[0, :3, 0] = -0.0
    gate = rng.uniform(0, 1, (n_groups, slots)).astype(np.float32)
    stt = rng.integers(0, g_sz + 1, (n_groups, slots)).astype(np.int32)
    return (jnp.asarray(yflat).astype(dtype), jnp.asarray(gate).astype(dtype),
            jnp.asarray(stt))


def _reference_combine(yflat, slot_gate, slot_to_token, g_sz):
    return jax.vmap(lambda yf, sg, stt: jax.ops.segment_sum(
        yf * sg[:, None], stt, g_sz + 1)[:g_sz])(yflat, slot_gate,
                                                 slot_to_token)


def _port_combine(yflat, slot_gate, slot_to_token, g_sz):
    return ttf._combine(params_from_arrays(np.asarray(yflat), "cpu"),
                        params_from_arrays(np.asarray(slot_gate), "cpu"),
                        torch.from_numpy(np.array(slot_to_token)), g_sz)


@pytest.mark.parametrize("n_groups", [1, 3])
def test_combine_float32_equals_segment_sum_bit_for_bit(n_groups):
    g_sz = 24
    args = _slot_space(n_groups, g_sz, 160, 8, jnp.float32)
    got = _port_combine(*args, g_sz)
    want = _reference_combine(*args, g_sz)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_combine_bfloat16_rounds_once():
    """Pinned difference by design (ROADMAP §C): the port sums the
    bfloat16 gated rows in float32 and rounds once; the reference's
    bfloat16 ``segment_sum`` rounds every partial sum."""
    g_sz = 24
    yflat, gate, stt = _slot_space(2, g_sz, 240, 16, jnp.bfloat16)
    got = _port_combine(yflat, gate, stt, g_sz)
    assert got.dtype == torch.bfloat16
    rows = (yflat * gate[..., None]).astype(jnp.float32)
    once = _reference_combine(rows, jnp.ones(gate.shape, jnp.float32), stt,
                              g_sz).astype(jnp.bfloat16)
    np.testing.assert_array_equal(_bits(got), _bits(once))
    per_sum = _reference_combine(yflat, gate, stt, g_sz)
    assert (_bits(got) != _bits(per_sum)).any()
    # ~10 terms a token: the per-partial-sum roundings stay within a few
    # ulps of the largest output (measured: 1)
    _within_ulps(got, per_sum, 8, of_max=True)


# -- the model -------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jcfg, tcfg, jp, tp = _carried(arch)
    toks = _tokens(jcfg.vocab, (2, 16))
    _close(ttf.lm_forward(tcfg, tp, torch.from_numpy(toks)),
           jtf.lm_forward(jcfg, jp, jnp.asarray(toks)), FWD_TOL)
    jl, jc = jtf.lm_prefill(jcfg, jp, jnp.asarray(toks))
    tl, tc = ttf.lm_prefill(tcfg, tp, torch.from_numpy(toks))
    _close(tl, jl, FWD_TOL)
    for key in ("k", "v"):
        _close(tc[key], jc[key], FWD_TOL)


@pytest.mark.parametrize("attn_chunk", [0, 8])
@pytest.mark.parametrize("vocab_chunk", [0, 8])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_matches_reference(arch, vocab_chunk, attn_chunk):
    """Both ``vocab_chunk`` paths and both attention paths (``attn_chunk``
    8 takes the online softmax over 4 chunks of the 32 positions)."""
    jcfg, tcfg, jp, tp = _carried(arch, vocab_chunk=vocab_chunk,
                                  attn_chunk=attn_chunk)
    toks = _tokens(jcfg.vocab, (2, 32))
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)], 1)
    want = jtf.lm_loss(jcfg, jp, jnp.asarray(toks), jnp.asarray(labels))
    got = ttf.lm_loss(tcfg, tp, torch.from_numpy(toks),
                      torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == ()
    assert _rel(got, want) < LOSS_TOL


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_then_decode_matches_reference(arch):
    """Prefill 8 positions, then 4 decode steps on given tokens: every
    step's logits and the final cache."""
    jcfg, tcfg, jp, tp = _carried(arch)
    toks = _tokens(jcfg.vocab, (2, 12))
    _, pc = jtf.lm_prefill(jcfg, jp, jnp.asarray(toks[:, :8]))
    jcache = jtf.init_kv_cache(jcfg, 2, 16, dtype=jnp.float32)
    jcache = {k: jcache[k].at[:, :, :8].set(pc[k]) for k in ("k", "v")}
    _, tpc = ttf.lm_prefill(tcfg, tp, torch.from_numpy(toks[:, :8]))
    tcache = ttf.init_kv_cache(tcfg, 2, 16, dtype=torch.float32,
                               device="cpu")
    for k in ("k", "v"):
        tcache[k][:, :, :8] = tpc[k]
    for i in range(4):
        step = toks[:, 8 + i:9 + i]
        jl, jcache = jtf.lm_decode_step(jcfg, jp, jcache, jnp.asarray(step),
                                        jnp.int32(8 + i))
        tl, tcache = ttf.lm_decode_step(tcfg, tp, tcache,
                                        torch.from_numpy(step), 8 + i)
        _close(tl, jl, FWD_TOL)
    for k in ("k", "v"):
        _close(tcache[k], jcache[k], FWD_TOL)
        assert not bool(tcache[k][:, :, 12:].any())


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_forward_in_the_port(arch):
    """Decode at position 8 after an 8-token prefill gives the forward's
    last-position logits over the 9 tokens (capacity factor 8: no drops
    on either path)."""
    cfg = tconfigs.reduced_config(arch)[0]
    params = ttf.init_lm_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(_tokens(cfg.vocab, (2, 9)))
    _, pc = ttf.lm_prefill(cfg, params, toks[:, :8])
    cache = ttf.init_kv_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for k in ("k", "v"):
        cache[k][:, :, :8] = pc[k]
    logits, back = ttf.lm_decode_step(cfg, params, cache, toks[:, 8:9], 8)
    assert back["k"] is cache["k"]                 # written in place
    x = ttf.lm_forward(cfg, params, toks)
    want = x[:, -1] @ params["lm_head"]
    _close(logits, want.numpy(), DECODE_TOL)


def test_bfloat16_reduced_config_matches_reference():
    jcfg, tcfg, jp, tp = _carried("stablelm-1.6b",
                                  param_dtype=jnp.bfloat16)
    assert {t.dtype for t in tree_leaves(tp)} == {torch.bfloat16}
    toks = _tokens(jcfg.vocab, (2, 16))
    got = ttf.lm_forward(tcfg, tp, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    _within_ulps(got, jtf.lm_forward(jcfg, jp, jnp.asarray(toks)),
                 BF16_ULPS, of_max=True)
    jl, jc = jtf.lm_prefill(jcfg, jp, jnp.asarray(toks))
    tl, tc = ttf.lm_prefill(tcfg, tp, torch.from_numpy(toks))
    assert tl.dtype == torch.float32 and tc["k"].dtype == torch.bfloat16
    _within_ulps(tl, jl, BF16_ULPS, of_max=True)


# -- serving, the CLIs, interop --------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_loop_greedy_tokens_equal_reference(arch, capsys):
    """The reference's ``serve --arch <a> --reduced`` (seed-0 weights,
    PRNGKey(1) prompts, 4 x 16, 8 steps) and ``serve_lm`` on the same
    weights and prompts give the same greedy tokens."""
    want = np.asarray(jserve.main(["--arch", arch, "--reduced"]))
    jcfg, tcfg, jp, tp = _carried(arch)
    toks = _tokens(jcfg.vocab, (4, 16))
    res = tserve.serve_lm(tcfg, tp, torch.from_numpy(toks), 8)
    assert res["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(res["tokens"].numpy(), want)
    assert len(res["decode_logits"]) == 7
    capsys.readouterr()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_cli_reduced_on_cpu(arch, capsys):
    out = tserve.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert tuple(out.shape) == (4, 8) and out.device.type == "cpu"
    assert int(out.min()) >= 0 and int(out.max()) < 256
    text = capsys.readouterr().out
    assert f"[serve] {arch}: prefill 4x16 + 8 decode steps in " in text
    assert "[serve] sampled token ids: " in text
    again = tserve.main(["--arch", arch, "--reduced", "--device", "cpu"])
    assert torch.equal(out, again)                 # seeded
    other = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--seed", "1", "--batch", "2", "--decode-steps",
                         "3"])
    assert tuple(other.shape) == (2, 3)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "qwen3-moe-30b-a3b"])
def test_train_cli_lm_waits_for_a10_3(arch):
    with pytest.raises(NotImplementedError, match="A10.3"):
        ttrain.main(["--arch", arch, "--reduced", "--device", "cpu"])


def test_serve_cli_rejects_a_non_lm():
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "pna", "--device", "cpu"])


def test_bfloat16_interop_round_trip_is_bit_exact():
    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.standard_normal((64, 33)) * 1e3).astype(jnp.bfloat16)
    a = a.at[0, :5].set(jnp.asarray([-0.0, jnp.inf, -jnp.inf, jnp.nan,
                                     1e-40], jnp.bfloat16))
    tree = {"w": np.asarray(a), "r": np.asarray(a.astype(jnp.float32)),
            "s": [np.asarray(a[0])]}
    back = params_from_arrays(tree, "cpu")
    assert back["w"].dtype == torch.bfloat16
    assert back["r"].dtype == torch.float32
    np.testing.assert_array_equal(_bits(back["w"]), _bits(a))
    np.testing.assert_array_equal(_bits(back["s"][0]), _bits(a[0]))
    np.testing.assert_array_equal(back["r"].numpy(),
                                  np.asarray(a.astype(jnp.float32)))

"""Decoder-only LM family: dense + MoE, GQA + RoPE, prefill and decode.

Counterpart of ``repro.models.transformer``, with its config, parameter
keys and layouts, for all five LM architectures:

* GQA attention with interleaved RoPE; activation SwiGLU or squared ReLU
  (nemotron);
* MoE (qwen3, llama4): per-group capacity dispatch by gather, top-k
  routing with the reference's tie rule and drops; the combine is the
  ``segment_reduce`` kernel (a sum by destination token, the sentinel of
  dropped slots outside the segments);
* ``moe_every``: 0 dense, 1 every layer MoE (qwen3), 2 alternating dense
  and MoE layers (llama4);
* decode: one token per step against a [L, B, S, KV, Dh] KV cache.

How the port differs in form, not in what it computes:

* Parameters are plain dicts of stacked [L, ...] leaf tensors, bfloat16 by
  default (the router float32), drawn from a ``torch.Generator`` a block at
  a time (``common.normal_init``), so their numbers differ from
  ``jax.random``'s; the attention and dense-FFN weights are one draw
  repeated over the layers, as the reference's are, as materialized copies.
* The reference scans over stacked layers; the port loops over them in
  Python. One loop serves all three ``moe_every`` patterns: layer ``l``
  takes attention ``l`` and the next FFN of its kind, which is what the
  reference's scans over (attn, ffn), (attn, moe) and the [0::2]/[1::2]
  super-layer pairs compute, with the cache in layer order.
* Every product the reference keeps in float32
  (``preferred_element_type=jnp.float32``) goes through
  ``common.matmul_f32``; the casts back to the model's dtype are where the
  reference's are.
* The combine rounds once: the gated expert outputs are formed in the
  model's dtype, summed in float32 by ``segment_reduce`` and cast back,
  where the reference's bfloat16 ``segment_sum`` rounds every partial sum
  (ROADMAP §C). In float32 the two are equal bit for bit.
* Decode writes the new key and value into the cache in place and returns
  the cache, as the reference returns its updated copy.

Dropped: the reference's ``constrain`` (sharding annotations), ``remat``
(rematerialization for the backward) and the ``scan_unroll`` and
``expert_zero1`` config knobs (an XLA roofline switch and an expert
sharding plan), which do nothing on one card. Training (``lm_loss``'s
gradients) waits for ROADMAP A10.3.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import segment_reduce
from repro_torch.models.common import (
    embed_init,
    matmul_f32,
    normal_init,
    rms_norm,
    softmax_cross_entropy,
    squared_relu_ffn,
    swiglu,
)
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None
    activation: str = "swiglu"          # "swiglu" | "squared_relu"
    # MoE
    moe_every: int = 0                   # 0 dense, 1 all-MoE, 2 alternating
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # numerics
    param_dtype: torch.dtype = torch.bfloat16
    rope_theta: float = 10_000.0
    attn_chunk: int = 0                  # 0 = unchunked scores; else KV chunks
    vocab_chunk: int = 0                 # 0 = full logits; else chunked CE loss

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.moe_every > 0

    def layer_kinds(self) -> list[str]:
        if self.moe_every == 0:
            return ["dense"] * self.n_layers
        if self.moe_every == 1:
            return ["moe"] * self.n_layers
        # llama4-style: [dense, moe] pairs
        return ["dense", "moe"] * (self.n_layers // 2)

    def param_count(self) -> int:
        """Parameters of ``init_lm_params``, counted on the meta device."""
        p = init_lm_params(None, self, device="meta")
        return sum(leaf.numel() for leaf in tree_leaves(p))


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _dense_init(gen, d_in: int, d_out: int, dtype, device) -> torch.Tensor:
    return normal_init(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype,
                       device)


def _stacked(w: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` copies of ``w`` on a new leading axis, each its own memory."""
    return w[None].repeat((n,) + (1,) * w.dim())


def _attn_params(gen, cfg: LMConfig, n: int, device):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dt = cfg.param_dtype

    def w(d_in, d_out, shape):
        return _stacked(_dense_init(gen, d_in, d_out, dt, device)
                        .reshape(shape), n)
    return {
        "wq": w(d, h * hd, (d, h, hd)),
        "wk": w(d, kv * hd, (d, kv, hd)),
        "wv": w(d, kv * hd, (d, kv, hd)),
        "wo": w(h * hd, d, (h, hd, d)),
        "ln1": torch.ones((n, d), dtype=dt, device=device),
        "ln2": torch.ones((n, d), dtype=dt, device=device),
    }


def _dense_ffn_params(gen, cfg: LMConfig, n: int, device):
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    p = {"w_up": _stacked(_dense_init(gen, d, f, dt, device), n),
         "w_down": _stacked(_dense_init(gen, f, d, dt, device), n)}
    if cfg.activation == "swiglu":
        p["w_gate"] = _stacked(_dense_init(gen, d, f, dt, device), n)
    return p


def _moe_params(gen, cfg: LMConfig, n: int, device):
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype
    scale = 1.0 / math.sqrt(d)

    def ew(a, b):
        return normal_init(gen, (n, e, a, b), scale, dt, device)
    p = {
        "router": _stacked(_dense_init(gen, d, e, torch.float32, device), n),
        "w_gate": ew(d, f),
        "w_up": ew(d, f),
        "w_down": ew(f, d),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "w_gate": _stacked(_dense_init(gen, d, fs, dt, device), n),
            "w_up": _stacked(_dense_init(gen, d, fs, dt, device), n),
            "w_down": _stacked(_dense_init(gen, fs, d, dt, device), n)}
    return p


def init_lm_params(gen: torch.Generator | None, cfg: LMConfig,
                   device: str | torch.device | None = None):
    """The reference's parameter tree on ``device`` (default ``gen``'s);
    ``device="meta"`` gives shapes and dtypes only (``gen`` may be None)."""
    device = torch.device(device if device is not None else gen.device)
    kinds = cfg.layer_kinds()
    n_dense = sum(k == "dense" for k in kinds)
    n_moe = sum(k == "moe" for k in kinds)
    params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype,
                            device),
        "attn": _attn_params(gen, cfg, len(kinds), device),
        "final_ln": torch.ones((cfg.d_model,), dtype=cfg.param_dtype,
                               device=device),
        "lm_head": _dense_init(gen, cfg.d_model, cfg.vocab, cfg.param_dtype,
                               device),
    }
    if n_dense:
        params["ffn"] = _dense_ffn_params(gen, cfg, n_dense, device)
    if n_moe:
        params["moe"] = _moe_params(gen, cfg, n_moe, device)
    return params


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """Interleaved RoPE: rotates the pairs (2i, 2i+1), not the two halves.
    x: [..., S, H, Dh]; positions: [..., S]."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = positions[..., None].float() * freqs           # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                   # over heads
    sin = torch.sin(ang)[..., None, :]
    xr = x.float().reshape(x.shape[:-1] + (half, 2))
    e, o = xr[..., 0], xr[..., 1]
    out = torch.stack([e * cos - o * sin, o * cos + e * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _softmax_(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis in place, as ``jax.nn.softmax`` forms it:
    ``exp(x - max) / sum``."""
    scores.sub_(scores.amax(dim=-1, keepdim=True)).exp_()
    return scores.div_(scores.sum(dim=-1, keepdim=True))


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...d,dhk->...hk", x, w)`` in float32."""
    d, h, k = w.shape
    return matmul_f32(x.reshape(-1, d), w.reshape(d, h * k)).reshape(
        x.shape[:-1] + (h, k))


def _out_project(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("...hk,hkd->...d", o, w)`` in float32."""
    h, k, d = w.shape
    return matmul_f32(o.reshape(-1, h * k), w.reshape(h * k, d)).reshape(
        o.shape[:-2] + (d,))


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``einsum("bqhk,bshk->bhqs", q, k)`` in float32."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    return matmul_f32(q.transpose(1, 2).reshape(b * h, sq, hd),
                      k.permute(0, 2, 3, 1).reshape(b * h, hd, sk)).view(
                          b, h, sq, sk)


def _weighted_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("bhqs,bshk->bqhk", p, v)`` in float32."""
    b, h, sq, sk = p.shape
    hd = v.shape[-1]
    out = matmul_f32(p.reshape(b * h, sq, sk),
                     v.transpose(1, 2).reshape(b * h, sk, hd))
    return out.view(b, h, sq, hd).transpose(1, 2)


def _attention_train(cfg: LMConfig, lp, x: torch.Tensor):
    """Causal GQA self-attention, [B, S, D] -> ([B, S, D], k, v); k/v
    [B, S, KV, Dh] before the heads are repeated, for the prefill cache."""
    b, s, d = x.shape
    g = cfg.n_heads // cfg.n_kv_heads
    dt = x.dtype
    xq = _project(x, lp["wq"]).to(dt)
    xk = _project(x, lp["wk"]).to(dt)
    xv = _project(x, lp["wv"]).to(dt)
    pos = torch.arange(s, device=x.device)
    xq = _rope(xq, pos, cfg.rope_theta)
    xk = _rope(xk, pos, cfg.rope_theta)
    kf = xk.repeat_interleave(g, dim=2)      # [B, S, H, Dh], jnp.repeat
    vf = xv.repeat_interleave(g, dim=2)
    scale = 1.0 / math.sqrt(cfg.head_dim)

    chunk = min(cfg.attn_chunk, s) if cfg.attn_chunk else 0
    if chunk and s % chunk == 0:
        out = _chunked_causal_attention(xq, kf, vf, scale, chunk)
    else:
        scores = _scores(xq, kf).mul_(scale)
        causal = pos[None, :] <= pos[:, None]            # [q, s]
        probs = _softmax_(scores.masked_fill_(~causal, -math.inf)).to(dt)
        del scores
        out = _weighted_values(probs, vf).to(dt)
    return _out_project(out, lp["wo"]).to(dt), xk, xv


def _chunked_causal_attention(xq, kf, vf, scale: float,
                              chunk: int) -> torch.Tensor:
    """Flash-style online softmax over KV chunks: never forms the [S, S]
    scores. xq/kf/vf: [B, S, H, Dh] (full heads)."""
    b, s, h, hd = xq.shape
    q_pos = torch.arange(s, device=xq.device)
    m = torch.full((b, h, s), -math.inf, device=xq.device)
    den = torch.zeros((b, h, s), device=xq.device)
    acc = torch.zeros((b, s, h, hd), device=xq.device)
    for lo in range(0, s, chunk):
        sc = _scores(xq, kf[:, lo:lo + chunk]).mul_(scale)
        k_pos = lo + torch.arange(chunk, device=xq.device)
        sc.masked_fill_(~(k_pos[None, :] <= q_pos[:, None]), -math.inf)
        new_m = torch.maximum(m, sc.amax(dim=-1))
        p = sc.sub_(new_m[..., None]).exp_()
        corr = torch.exp(m - new_m)
        den = den * corr + p.sum(dim=-1)
        pv = _weighted_values(p.to(vf.dtype), vf[:, lo:lo + chunk])
        acc = acc * corr.transpose(1, 2)[..., None] + pv
        m = new_m
    out = acc / den.transpose(1, 2)[..., None]
    return out.to(vf.dtype)


def _dense_ffn(cfg: LMConfig, lp, x: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        return swiglu(x, lp["w_gate"], lp["w_up"], lp["w_down"])
    return squared_relu_ffn(x, lp["w_up"], lp["w_down"])   # nemotron


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: LMConfig, lp, xg: torch.Tensor):
    """Router of ``_moe_ffn``: (top_p, top_i) [G, T, k], the top-k
    probabilities renormalized to sum to 1, and their experts."""
    g, t, d = xg.shape
    logits = matmul_f32(xg.reshape(g * t, d), lp["router"])
    probs = _softmax_(logits).view(g, t, -1)
    top_p, top_i = _top_k(probs, cfg.top_k)
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)
    return top_p, top_i


def _capacity_positions(flat_i: torch.Tensor) -> torch.Tensor:
    """Each (token, choice)'s position within its expert, [G, T*k]: its
    rank among the group's choices of that expert in token-major order (a
    stable argsort and the sorted runs' starts, as the reference's)."""
    order = torch.argsort(flat_i, dim=-1, stable=True)
    se = torch.gather(flat_i, 1, order)
    run_start = torch.searchsorted(se, se, side="left")
    pos_sorted = torch.arange(flat_i.shape[1], device=flat_i.device) - run_start
    return torch.empty_like(flat_i).scatter_(1, order, pos_sorted)


def _scatter_drop(n_groups: int, width: int, index: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``zeros[G, width].at[index].set(src, mode="drop")`` for ``index`` in
    ``[0, width]``: ``width`` is a sentinel column, sliced off."""
    out = torch.zeros((n_groups, width + 1), dtype=src.dtype,
                      device=src.device)
    return out.scatter_(1, index, src)[:, :width]


def _combine(yflat: torch.Tensor, slot_gate: torch.Tensor,
             slot_to_token: torch.Tensor, g_sz: int) -> torch.Tensor:
    """``segment_sum(yf * sg[:, None], stt, g_sz + 1)[:g_sz]`` per group:
    yflat [G, E*cap, D], slot_gate [G, E*cap] and the result in the
    model's dtype, slot_to_token [G, E*cap] with the sentinel ``g_sz``.
    One ``segment_reduce`` call over all groups (group ``i``'s tokens are
    segments ``i * g_sz ...``; sentinels become -1, which it drops)."""
    n_groups, slots, d = yflat.shape
    rows = (yflat * slot_gate[..., None]).float().reshape(-1, d)
    offset = torch.arange(n_groups, device=yflat.device)[:, None] * g_sz
    ids = torch.where(slot_to_token < g_sz, slot_to_token + offset,
                      -1).reshape(-1).to(torch.int32)
    out = segment_reduce(rows, ids, num_segments=n_groups * g_sz)
    return out.view(n_groups, g_sz, d).to(yflat.dtype)


def _moe_ffn(cfg: LMConfig, lp, x: torch.Tensor,
             n_groups: int) -> torch.Tensor:
    """Capacity-based top-k MoE: gather dispatch, expert FFNs over the
    stacked expert weights, ``segment_reduce`` combine. x [B, S, D] is cut
    into ``n_groups`` groups of tokens, each with its own capacity."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    xg = x.reshape(n_groups, (b * s) // n_groups, d)
    g_sz = xg.shape[1]
    cap = int(math.ceil(k * g_sz / e * cfg.capacity_factor))
    cap = max(cap, k)

    top_p, top_i = _route(cfg, lp, xg)
    flat_i = top_i.reshape(n_groups, g_sz * k)
    pos = _capacity_positions(flat_i)
    ok = pos < cap

    # expert slot buffers: the token feeding each slot [G, E * cap]
    slot = flat_i * cap + torch.clamp(pos, max=cap - 1)
    token_id = torch.arange(g_sz, device=x.device).repeat_interleave(k)
    token_id = token_id.expand(n_groups, -1)
    slot_safe = torch.where(ok, slot, e * cap)   # dropped -> the sentinel
    slot_token = _scatter_drop(n_groups, e * cap, slot_safe, token_id)
    slot_valid = _scatter_drop(n_groups, e * cap, slot_safe,
                               torch.ones_like(ok))

    xe = torch.gather(xg, 1, slot_token[..., None].expand(-1, -1, d))
    xe.mul_(slot_valid[..., None].to(dt))

    # expert FFN: [E, G * cap, D] against the stacked [E, D, F] weights
    xe = xe.view(n_groups, e, cap, d).transpose(0, 1).reshape(
        e, n_groups * cap, d)
    gate = matmul_f32(xe, lp["w_gate"])
    up = matmul_f32(xe, lp["w_up"])
    h = (F.silu(gate) * up).to(dt)
    del gate, up
    ye = matmul_f32(h, lp["w_down"]).to(dt)
    yflat = ye.view(e, n_groups, cap, d).transpose(0, 1).reshape(
        n_groups, e * cap, d)

    # combine: gate probabilities onto their slots, a segment sum in slot
    # space by destination token
    gate_p = top_p.reshape(n_groups, g_sz * k).to(dt)
    slot_gate = _scatter_drop(n_groups, e * cap, slot_safe, gate_p)
    slot_to_token = torch.where(slot_valid, slot_token, g_sz)
    y = _combine(yflat, slot_gate, slot_to_token, g_sz)

    if cfg.n_shared_experts:
        sp = lp["shared"]
        y = y + swiglu(xg, sp["w_gate"], sp["w_up"], sp["w_down"])
    return y.reshape(b, s, d)


# ---------------------------------------------------------------------------
# forward / losses
# ---------------------------------------------------------------------------

def _layer(stack, i: int):
    return tree_map(lambda a: a[i], stack)


def _ffn_stacks(cfg: LMConfig, params):
    """Per layer, (kind, that layer's FFN parameters): layer ``l`` takes the
    next dense or MoE entry of its stack."""
    seen = {"dense": 0, "moe": 0}
    out = []
    for kind in cfg.layer_kinds():
        stack = params["ffn"] if kind == "dense" else params["moe"]
        out.append((kind, _layer(stack, seen[kind])))
        seen[kind] += 1
    return out


def _layer_stack(cfg: LMConfig, params, x: torch.Tensor, n_groups: int,
                 with_cache: bool = False):
    """All layers over x [B, S, D]; ``with_cache`` also returns every
    layer's (k, v) as ``{"k", "v"}`` [L, B, S, KV, Dh]."""
    cache = None
    if with_cache:
        b, s, _ = x.shape
        shape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
        cache = {"k": torch.empty(shape, dtype=x.dtype, device=x.device),
                 "v": torch.empty(shape, dtype=x.dtype, device=x.device)}
    for l, (kind, lf) in enumerate(_ffn_stacks(cfg, params)):
        la = _layer(params["attn"], l)
        o, k, v = _attention_train(cfg, la, rms_norm(x, la["ln1"]))
        x = x + o
        h = rms_norm(x, la["ln2"])
        x = x + (_dense_ffn(cfg, lf, h) if kind == "dense"
                 else _moe_ffn(cfg, lf, h, n_groups))
        if with_cache:
            cache["k"][l] = k
            cache["v"][l] = v
    return x, cache


def lm_forward(cfg: LMConfig, params, tokens: torch.Tensor,
               n_groups: int = 1) -> torch.Tensor:
    """tokens [B, S] -> final hidden [B, S, D]."""
    x = params["embed"][tokens.long()]
    x, _ = _layer_stack(cfg, params, x, n_groups)
    return rms_norm(x, params["final_ln"])


def lm_prefill(cfg: LMConfig, params, tokens: torch.Tensor,
               n_groups: int = 1):
    """Prefill: last-position logits (float32 [B, V]) and the full KV
    cache ``{"k", "v"}`` [L, B, S, KV, Dh]."""
    x = params["embed"][tokens.long()]
    x, cache = _layer_stack(cfg, params, x, n_groups, with_cache=True)
    x = rms_norm(x, params["final_ln"])
    return matmul_f32(x[:, -1], params["lm_head"]), cache


def lm_loss(cfg: LMConfig, params, tokens: torch.Tensor,
            labels: torch.Tensor, n_groups: int = 1) -> torch.Tensor:
    """Mean next-token cross entropy (labels < 0 masked); with
    ``vocab_chunk``, averaged over sequence chunks whose [B, chunk, V]
    logits are formed one at a time."""
    x = lm_forward(cfg, params, tokens, n_groups)
    b, s, d = x.shape
    head = params["lm_head"]
    if cfg.vocab_chunk:
        n_chunks = max(1, s // cfg.vocab_chunk)
        xs = x.reshape(b, n_chunks, cfg.vocab_chunk, d)
        ls = labels.reshape(b, n_chunks, cfg.vocab_chunk)
        tot = torch.zeros((), device=x.device)
        for c in range(n_chunks):
            logits = matmul_f32(xs[:, c].reshape(-1, d), head)
            tot = tot + softmax_cross_entropy(
                logits.view(b, cfg.vocab_chunk, -1), ls[:, c])
        return tot / n_chunks
    logits = matmul_f32(x.reshape(-1, d), head).view(b, s, -1)
    return softmax_cross_entropy(logits, labels)


# -- decode -----------------------------------------------------------------

def init_kv_cache(cfg: LMConfig, batch: int, max_seq: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: str | torch.device = "cuda"):
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def lm_decode_step(cfg: LMConfig, params, cache, tokens: torch.Tensor,
                   pos: int):
    """One decode step: tokens [B, 1] at position ``pos`` (the current
    length). Returns (float32 logits [B, vocab], cache), the new key and
    value written into ``cache`` at ``pos``; the whole cache is read once,
    the positions after ``pos`` masked."""
    b = tokens.shape[0]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = h // kv
    s_max = cache["k"].shape[2]
    x = params["embed"][tokens[:, 0].long()]          # [B, D]
    dt = x.dtype
    scale = 1.0 / math.sqrt(hd)
    invalid = torch.arange(s_max, device=x.device) > pos
    posb = torch.full((b, 1), pos, device=x.device)

    for l, (kind, lf) in enumerate(_ffn_stacks(cfg, params)):
        lp = _layer(params["attn"], l)
        k_l, v_l = cache["k"][l], cache["v"][l]       # [B, S, KV, Dh]
        hn = rms_norm(x, lp["ln1"])
        q = _rope(_project(hn, lp["wq"]).to(dt)[:, None], posb,
                  cfg.rope_theta)[:, 0]
        kx = _rope(_project(hn, lp["wk"]).to(dt)[:, None], posb,
                   cfg.rope_theta)[:, 0]
        vx = _project(hn, lp["wv"]).to(dt)
        k_l[:, pos] = kx.to(k_l.dtype)
        v_l[:, pos] = vx.to(v_l.dtype)
        # "bkgh,bskh->bkgs" and "bkgs,bskh->bkgh" as [B * KV] batches
        sc = matmul_f32(q.reshape(b * kv, g, hd),
                        k_l.permute(0, 2, 3, 1).reshape(b * kv, hd, s_max))
        sc.mul_(scale).masked_fill_(invalid, -math.inf)
        p = _softmax_(sc).to(v_l.dtype)
        o = matmul_f32(p, v_l.transpose(1, 2).reshape(b * kv, s_max, hd))
        x = x + _out_project(o.to(dt).reshape(b, h, hd), lp["wo"]).to(dt)
        hn = rms_norm(x, lp["ln2"])
        if kind == "dense":
            x = x + _dense_ffn(cfg, lf, hn)
        else:
            x = x + _moe_ffn(cfg, lf, hn[:, None, :], 1)[:, 0]

    x = rms_norm(x, params["final_ln"])
    return matmul_f32(x, params["lm_head"]), cache

"""LM-family cells: train_4k / prefill_32k / decode_32k / long_500k.

Counterpart of ``repro.configs.lm_family``: the same ``LM_SHAPES``, the
reference's sharding plan (``lm_param_specs``, ``lm_opt_specs``), the
abstract state on the meta device (``abstract_lm_state``) and the cells
(``make_lm_cell``), and ``reduced_lm_config``.

The sharding plan, as the reference states it: parameters FSDP over
``data`` x tensor-parallel over ``model`` (Megatron row/column splits),
experts over ``model``, the embedding's vocabulary over ``model``; train
activations batch over (pod, data); the decode KV cache batch over (pod,
data) and sequence over ``model``, long_500k (batch 1) its sequence over
both axes. The port runs a cell whole on one card: the specs feed the dry
run's per-device bytes, and the step is the port's own (``lm_loss``'s
gradients and ``adamw_update``, as ``launch/train.py`` computes them;
``lm_prefill``; ``lm_decode_step``), with the MoE groups
(``n_groups``) the reference's mesh gives it. The reference's
``constrain`` annotations change no value and have no counterpart.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import Cell, MeshAxes, P, meta_tensor
from repro_torch.models.transformer import (
    LMConfig,
    init_kv_cache,
    init_lm_params,
    lm_decode_step,
    lm_loss,
    lm_prefill,
)
from repro_torch.optim import adamw_init
from repro_torch.optim.adamw import AdamWState

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


# -- param specs --------------------------------------------------------------

def lm_param_specs(cfg: LMConfig, ax: MeshAxes, tp_size: int = 16):
    """The reference's parameter specs: a tree shaped like
    ``init_lm_params``'s of :class:`PartitionSpec` s."""
    f, m = ax.fsdp, ax.model
    if cfg.n_heads % tp_size == 0:
        # Megatron head-parallel attention
        attn = {
            "wq": P(None, f, m, None),
            "wk": P(None, f, None, None),
            "wv": P(None, f, None, None),
            "wo": P(None, m, None, f),
        }
    else:
        # head_dim-parallel fallback (llama4 40 heads, llama3.2 24)
        attn = {
            "wq": P(None, f, None, m),
            "wk": P(None, f, None, m),
            "wv": P(None, f, None, m),
            "wo": P(None, None, m, f),
        }
    attn.update({"ln1": P(None, None), "ln2": P(None, None)})
    specs = {
        "embed": P(m, f),
        "attn": attn,
        "final_ln": P(None),
        "lm_head": P(f, m),
    }
    kinds = cfg.layer_kinds()
    if "dense" in kinds:
        ffn = {"w_up": P(None, f, m), "w_down": P(None, m, f)}
        if cfg.activation == "swiglu":
            ffn["w_gate"] = P(None, f, m)
        specs["ffn"] = ffn
    if "moe" in kinds:
        moe = {
            "router": P(None, f, None),
            "w_gate": P(None, m, f, None),
            "w_up": P(None, m, f, None),
            "w_down": P(None, m, None, f),
        }
        if cfg.n_shared_experts:
            moe["shared"] = {"w_gate": P(None, f, m), "w_up": P(None, f, m),
                             "w_down": P(None, m, f)}
        specs["moe"] = moe
    return specs


def lm_opt_specs(param_specs) -> AdamWState:
    """AdamW's ``m`` and ``v`` as the parameters, ``count`` replicated.
    The reference's ``expert_zero1`` layout (the experts' ``m`` and ``v``
    split over data) is not ported: no configuration sets it."""
    return AdamWState(m=param_specs, v=param_specs, count=P())


def abstract_lm_state(cfg: LMConfig, with_opt: bool):
    """(parameters, AdamW state or None) on the meta device."""
    params = init_lm_params(None, cfg, device="meta")
    return params, adamw_init(params) if with_opt else None


# -- cells --------------------------------------------------------------------

def make_lm_cell(cfg: LMConfig, shape_id: str, mesh) -> Cell:
    """The ``<cfg.name>/<shape_id>`` cell on ``mesh``, its MoE layers cut
    into the mesh's ``n_batch_shards`` token groups, as the reference's
    (the train and prefill cells' ``trace_key`` for a MoE config).

    * train: ``fn(params, opt, batch)`` -> ``(params, opt, {"loss",
      "grad_norm"})``, one ``launch.train.train_step`` at the reference's
      AdamW defaults (lr 1e-4, weight decay 0.1);
    * prefill: ``fn(params, tokens)`` -> ``(logits, cache)``, with
      ``attn_chunk`` 2048 where the config has none (a 32k prefill cannot
      form its [S, S] scores);
    * decode: ``fn(params, cache, tokens, pos)`` -> ``(logits, cache)``.
      ``pos`` is a 0-d int32 tensor, as the reference's, read on the host
      for ``lm_decode_step``'s int position; on the meta device, where it
      has no value, position 0 stands in (no shape depends on it).

    Prefill and decode run without autograd.
    """
    ax = MeshAxes.for_mesh(mesh)
    sh = LM_SHAPES[shape_id]
    b, s = sh["batch"], sh["seq"]
    pspecs = lm_param_specs(cfg, ax, tp_size=mesh.shape[ax.model])
    bd = ax.batch
    n_groups = ax.n_batch_shards(mesh)
    # only the MoE layers read n_groups, in the train and prefill steps
    moe_groups = n_groups if cfg.is_moe else None
    name = f"{cfg.name}/{shape_id}"

    if sh["kind"] == "train":
        from repro_torch.launch.train import train_step
        params, opt = abstract_lm_state(cfg, with_opt=True)
        batch = {"tokens": meta_tensor((b, s), torch.int32),
                 "labels": meta_tensor((b, s), torch.int32)}
        ospecs = lm_opt_specs(pspecs)

        def loss_fn(p, batch):
            return lm_loss(cfg, p, batch["tokens"], batch["labels"],
                           n_groups=n_groups)

        def lm_train_step(params, opt_state, batch):
            new_p, new_o, loss, gnorm = train_step(
                loss_fn, params, opt_state, batch, lr=1e-4,
                weight_decay=0.1)
            return new_p, new_o, {"loss": loss, "grad_norm": gnorm}

        return Cell(
            name=name, fn=lm_train_step, args=(params, opt, batch),
            in_specs=(pspecs, ospecs,
                      {"tokens": P(bd, None), "labels": P(bd, None)}),
            out_specs=(pspecs, ospecs, {"loss": P(), "grad_norm": P()}),
            donate=(0, 1), trace_key=moe_groups)

    if sh["kind"] == "prefill":
        if cfg.attn_chunk == 0:
            cfg = dataclasses.replace(cfg, attn_chunk=2048)
        params, _ = abstract_lm_state(cfg, with_opt=False)
        cache_spec = {"k": P(None, bd, ax.model, None, None),
                      "v": P(None, bd, ax.model, None, None)}

        def prefill_step(params, tokens):
            with torch.no_grad():
                return lm_prefill(cfg, params, tokens, n_groups=n_groups)

        return Cell(
            name=name, fn=prefill_step,
            args=(params, meta_tensor((b, s), torch.int32)),
            in_specs=(pspecs, P(bd, None)),
            out_specs=(P(bd, ax.model), cache_spec),
            trace_key=moe_groups)

    params, _ = abstract_lm_state(cfg, with_opt=False)
    cache = init_kv_cache(cfg, b, s, device="meta")
    if b % n_groups == 0:
        cbatch, cseq = bd, ax.model
    else:  # long_500k: batch 1, both axes on the sequence
        cbatch, cseq = None, (ax.fsdp, ax.model)
    cache_spec = {"k": P(None, cbatch, cseq, None, None),
                  "v": P(None, cbatch, cseq, None, None)}

    def decode_step(params, cache, tokens, pos):
        with torch.no_grad():
            return lm_decode_step(cfg, params, cache, tokens,
                                  0 if pos.is_meta else int(pos))

    return Cell(
        name=name, fn=decode_step,
        args=(params, cache, meta_tensor((b, 1), torch.int32),
              meta_tensor((), torch.int32)),
        in_specs=(pspecs, cache_spec, P(cbatch, None), P()),
        out_specs=(P(cbatch, ax.model), cache_spec),
        donate=(1,))


def reduced_lm_config(cfg: LMConfig) -> LMConfig:
    """Same family, smoke-testable on one CPU core."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        d_head=16,
        d_ff=128,
        moe_d_ff=64 if cfg.is_moe else 0,
        n_experts=4 if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        vocab=256,
        param_dtype=torch.float32,
        # drop-free routing so decode == forward exactly in equivalence tests
        capacity_factor=8.0,
    )

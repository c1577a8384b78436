"""DIEN (Zhou et al., arXiv:1809.03672): Deep Interest Evolution Network.

Counterpart of ``repro.models.dien``, with the same config, parameter keys
and batch layout: sparse embeddings (item 2^23 rows, category 10^4 rows,
dim 18) -> interest-extraction GRU over the 100-step behavior sequence ->
AUGRU (attention-gated GRU conditioned on the target item) -> MLP
200-80-2, plus the auxiliary next-behavior loss on the GRU states.

On the card:

* the sum-pooled history is two bag sums (item and category rows, weights
  = the history mask), concatenated: the ``embedding_bag`` kernel, where
  the reference sums ``beh * mask`` over the sequence axis (the same sum in
  another order);
* every row gather (``embedding_lookup``) has ``segment_reduce``'s
  deterministic backward, with one layout per index array and forward;
* the two recurrences are Python loops over the sequence with
  ``torch.where`` on the mask, where the reference scans;
* retrieval (1 user x 10^6 candidates) runs the GRU once and the AUGRU and
  head over the candidate axis in chunks of ``CANDIDATE_CHUNK``: the
  one-card counterpart of the reference's candidate axis sharded over the
  mesh.

Float32 only; the reference's ``scan_unroll`` (an XLA roofline knob) has no
counterpart.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels.segment_reduce import contiguous_layout
from repro_torch.models.common import dense_init, mlp_apply, mlp_params
from repro_torch.models.embedding import embedding_bag, embedding_lookup

# Candidates per AUGRU/head pass in ``dien_score_candidates``. Unchunked,
# the attention input alone at 1,000,448 candidates x 100 steps x 144 is
# 57.6 GB of float32; a chunk of 2^17 keeps it at 7.5 GB.
CANDIDATE_CHUNK = 1 << 17


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str
    n_items: int = 1 << 23
    n_cats: int = 10_000
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: tuple[int, ...] = (200, 80)

    @property
    def d_behavior(self) -> int:            # concat(item, cat) embedding
        return 2 * self.embed_dim


def _gru_params(gen: torch.Generator | None, d_in: int, d_h: int, device):
    return {
        "wi": dense_init(gen, d_in, 3 * d_h, device=device),  # update/reset/cand input
        "wh": dense_init(gen, d_h, 3 * d_h, device=device),
        "b": torch.zeros((3 * d_h,), device=device),
    }


def _gru_cell(p, h, x, att=None):
    """GRU cell; if ``att`` given, AUGRU: update gate scaled by attention."""
    gi = x @ p["wi"]
    gh = h @ p["wh"]
    d = p["wh"].shape[0]
    zi, ri, ci = gi[..., :d], gi[..., d:2 * d], gi[..., 2 * d:]
    zh, rh, ch = gh[..., :d], gh[..., d:2 * d], gh[..., 2 * d:]
    b = p["b"]
    z = torch.sigmoid(zi + zh + b[:d])
    r = torch.sigmoid(ri + rh + b[d:2 * d])
    c = torch.tanh(ci + r * ch + b[2 * d:])
    if att is not None:
        z = z * att[..., None]               # AUGRU: attentional update gate
    return (1.0 - z) * h + z * c


def init_dien_params(gen: torch.Generator | None, cfg: DIENConfig,
                     device: str | torch.device | None = None):
    """Parameters drawn from ``gen`` on ``device`` (default ``gen``'s; the
    reference's keys and shapes, other numbers); ``device="meta"`` gives
    shapes and dtypes only (``gen`` may be None)."""
    device = torch.device(device if device is not None else gen.device)
    d, dh = cfg.d_behavior, cfg.gru_dim
    d_final = dh + d + d                     # interest ++ target emb ++ sum-pooled history
    return {
        "item_emb": torch.randn((cfg.n_items, cfg.embed_dim), generator=gen,
                                device=device) * 0.02,
        "cat_emb": torch.randn((cfg.n_cats, cfg.embed_dim), generator=gen,
                               device=device) * 0.02,
        "gru1": _gru_params(gen, d, dh, device),
        "augru": _gru_params(gen, d, dh, device),
        "att": mlp_params(gen, (dh + d, 80, 1), device=device),
        "mlp": mlp_params(gen, (d_final,) + cfg.mlp_dims + (2,),
                          device=device),
        "aux": mlp_params(gen, (dh + d, 100, 1), device=device),
    }


def _behavior_embed(params, item_ids, cat_ids):
    it = embedding_lookup(params["item_emb"], item_ids)
    ct = embedding_lookup(params["cat_emb"], cat_ids)
    return torch.cat([it, ct], -1)           # [..., 2*embed_dim]


def _pooled_history(params, item_ids, cat_ids, mask):
    """The mask-weighted sum of each row's behavior embeddings: [B, S]
    histories -> [B, 2*embed_dim], one bag per row and table."""
    b, s = item_ids.shape
    layout = contiguous_layout(b, s, item_ids.device)
    w = mask.reshape(-1).float()
    return torch.cat([
        embedding_bag(params[name], ids.reshape(-1), layout.seg, b, weights=w,
                      layout=layout)
        for name, ids in (("item_emb", item_ids), ("cat_emb", cat_ids))], -1)


def _interest_extraction(cfg, params, beh, mask):
    """GRU over the behavior sequence. beh: [B, S, D]. Returns states [B, S, dh]."""
    h = beh.new_zeros((beh.shape[0], cfg.gru_dim))
    states = []
    for t in range(beh.shape[1]):
        h_new = _gru_cell(params["gru1"], h, beh[:, t])
        h = torch.where(mask[:, t, None], h_new, h)
        states.append(h)
    return torch.stack(states, 1)              # [B, S, dh]


def _interest_evolution(cfg, params, states, beh, mask, target):
    """AUGRU over GRU states with attention to the target item.

    states [B, S, dh]; target [B, D]. Returns final interest [B, dh].
    """
    b, s = states.shape[:2]
    att_in = torch.cat([states, target[:, None].expand(b, s, -1)], -1)
    att_logit = mlp_apply(params["att"], att_in)[..., 0]   # [B, S]
    att_logit = torch.where(mask, att_logit, -torch.inf)
    att = torch.softmax(att_logit.float(), dim=-1)
    del att_in   # the largest tensor of a serving call: free it before the loop
    h = states.new_zeros((b, cfg.gru_dim))
    for t in range(s):
        h_new = _gru_cell(params["augru"], h, beh[:, t], att=att[:, t])
        h = torch.where(mask[:, t, None], h_new, h)
    return h


def dien_forward(cfg: DIENConfig, params, batch):
    """batch: hist_items/hist_cats [B, S], hist_mask [B, S],
    target_item/target_cat [B]. Returns (logits [B, 2], states, beh, mask)."""
    beh = _behavior_embed(params, batch["hist_items"], batch["hist_cats"])
    target = _behavior_embed(params, batch["target_item"], batch["target_cat"])
    mask = batch["hist_mask"]
    states = _interest_extraction(cfg, params, beh, mask)
    interest = _interest_evolution(cfg, params, states, beh, mask, target)
    pooled = _pooled_history(params, batch["hist_items"], batch["hist_cats"],
                             mask)
    x = torch.cat([interest, target, pooled], -1)
    return mlp_apply(params["mlp"], x), states, beh, mask


def dien_loss(cfg: DIENConfig, params, batch) -> torch.Tensor:
    logits, states, beh, mask = dien_forward(cfg, params, batch)
    labels = batch["label"].long()
    lp = F.log_softmax(logits.float(), -1)
    ce = -torch.mean(torch.take_along_dim(lp, labels[:, None], 1))

    # auxiliary loss: state_t should predict behavior_{t+1} (positive) vs
    # a shuffled negative (the batch rolled by one is the negative sample).
    h_t = states[:, :-1]
    e_pos = beh[:, 1:]
    e_neg = torch.roll(e_pos, 1, dims=0)
    m = mask[:, 1:].float()

    def aux_logit(e):
        return mlp_apply(params["aux"], torch.cat([h_t, e], -1))[..., 0]
    pos = F.logsigmoid(aux_logit(e_pos).float())
    neg = F.logsigmoid(-aux_logit(e_neg).float())
    aux = -torch.sum((pos + neg) * m) / torch.clamp(torch.sum(m), min=1.0)
    return ce + 1.0 * aux


def dien_score_candidates(cfg: DIENConfig, params, batch):
    """Retrieval scoring: 1 user vs n_cand candidates.

    batch: hist_* [1, S]; cand_items/cand_cats [n_cand]. The GRU and the
    pooled history run once; the AUGRU and head run over the candidates in
    chunks of ``CANDIDATE_CHUNK``. Returns [n_cand] scores (logit margins).
    """
    beh = _behavior_embed(params, batch["hist_items"], batch["hist_cats"])  # [1,S,D]
    mask = batch["hist_mask"]
    states = _interest_extraction(cfg, params, beh, mask)                   # [1,S,dh]
    pooled = _pooled_history(params, batch["hist_items"], batch["hist_cats"],
                             mask)                                          # [1,D]
    cands = _behavior_embed(params, batch["cand_items"], batch["cand_cats"])  # [C,D]
    scores = []
    for start in range(0, cands.shape[0], CANDIDATE_CHUNK):
        c = cands[start:start + CANDIDATE_CHUNK]
        n = c.shape[0]
        interest = _interest_evolution(
            cfg, params, states.expand(n, -1, -1), beh.expand(n, -1, -1),
            mask.expand(n, -1), c)                                          # [n,dh]
        x = torch.cat([interest, c, pooled.expand(n, -1)], -1)
        logits = mlp_apply(params["mlp"], x)
        scores.append(logits[:, 1] - logits[:, 0])
    return torch.cat(scores)

"""DIEN (Zhou et al., arXiv:1809.03672): interest evolution with a GRU and
an AUGRU (attention-gated GRU) over the behaviour sequence.

embed_dim=18, seq_len=100, gru_dim=108, MLP 200-80 -> CTR logit, and the
paper's auxiliary next-behaviour loss on the first GRU's states.  The JAX
package's ``lax.scan`` over the sequence is a loop over it here, in
time-major layout ([S, B, .]) so that each step reads contiguous rows; the
three gates' input weights and the r and z gates' hidden weights are
concatenated once a sequence (the same sums, fewer products).

``mesh``: as SASRec's (``item_emb`` this rank's row block over "model", the
batch this rank's block over the batch axes); None, every tensor whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import P, check_mesh
from repro_torch.models.layers import (
    _dense_init,
    dense_stack,
    dense_stack_init,
    make_generator,
    normal,
)
from repro_torch.models.recsys.embedding import batch_mean, batch_ratio, table_spec, take
from repro_torch.train.tree import tree_map


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str = "dien"
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp: tuple = (200, 80)
    n_items: int = 1_000_000
    aux_weight: float = 0.5
    dtype: Any = torch.float32


def _gru_init(g, d_in, d_h, dtype, device):
    return {gate: {"wx": _dense_init(g, (d_in, d_h), dtype, device),
                   "wh": _dense_init(g, (d_h, d_h), dtype, device),
                   "b": torch.zeros((d_h,), dtype=dtype, device=device)}
            for gate in ("r", "z", "h")}


def init(cfg: DIENConfig, generator=None, *, device="cuda"):
    g = generator if generator is not None else make_generator(device)
    d, h = cfg.embed_dim, cfg.gru_dim
    return {
        "item_emb": normal((cfg.n_items, d), g, device, d**-0.5, cfg.dtype),
        "gru1": _gru_init(g, d, h, cfg.dtype, device),
        "augru": _gru_init(g, h, h, cfg.dtype, device),
        "attn_w": _dense_init(g, (d, h), cfg.dtype, device),
        # final features: [h_T (g), target (d)]
        "mlp": dense_stack_init(g, [h + d, *cfg.mlp, 1], cfg.dtype, device),
    }


def specs(cfg):
    """JAX's spec tree: every leaf replicated but the item table, row-sharded over "model"."""
    s = tree_map(lambda _: P(), init(cfg, device="meta"))
    s["item_emb"] = table_spec()
    return s


def _concat(p):
    """The three gates' input weights [d_in, 3 d_h] and the r and z gates'
    hidden weights [d_h, 2 d_h], side by side."""
    return (torch.cat([p["r"]["wx"], p["z"]["wx"], p["h"]["wx"]], dim=1),
            torch.cat([p["r"]["wh"], p["z"]["wh"]], dim=1))


def _gru_gates(p, x, h, cat=None):
    """(z, h~) of one GRU step, x [B, d_in], h [B, d_h]: r and z are
    sigmoid(x wx + h wh + b), h~ = tanh(x wx_h + (r h) wh_h + b_h).  ``cat``:
    ``_concat(p)``, made once a sequence."""
    wx, wh = cat if cat is not None else _concat(p)
    d_h = wh.shape[0]
    xw, hw = x @ wx, h @ wh
    r = torch.sigmoid(xw[:, :d_h] + hw[:, :d_h] + p["r"]["b"])
    z = torch.sigmoid(xw[:, d_h:2 * d_h] + hw[:, d_h:] + p["z"]["b"])
    hh = torch.tanh(xw[:, 2 * d_h:] + (r * h) @ p["h"]["wh"] + p["h"]["b"])
    return z, hh


def _run_gru(p, xs, mask, att=None):
    """The GRU over time-major xs [S, B, d_in] with mask [S, B] (a masked
    step keeps the state): the states [S, B, d_h].  With ``att`` [S, B] the
    AUGRU: the update gate scaled by the attention score a_t."""
    cat = _concat(p)
    h = torch.zeros((xs.shape[1], cat[1].shape[0]), dtype=xs.dtype, device=xs.device)
    states = []
    for t in range(xs.shape[0]):
        z, hh = _gru_gates(p, xs[t], h, cat)
        if att is not None:
            z = z * att[t][:, None]
        h_new = (1.0 - z) * h + z * hh
        h = torch.where(mask[t][:, None], h_new, h)
        states.append(h)
    return torch.stack(states)


def forward(params, batch, cfg: DIENConfig, mesh=None):
    """batch = {hist [B, S] int32 (-1 pad), target [B] int32} -> (logit [B],
    gru1 states [B, S, g]); the states feed the auxiliary loss."""
    check_mesh(mesh)
    hist, target = batch["hist"], batch["target"]
    hist_t = hist.t()
    mask_t = hist_t >= 0                                               # [S, B]
    e_t = take(params["item_emb"], hist_t, mesh)                      # [S, B, d]
    te = take(params["item_emb"], target, mesh)                       # [B, d]

    states_t = _run_gru(params["gru1"], e_t, mask_t)                     # [S, B, g]

    att_logits = torch.einsum("sbd,bd->bs", states_t @ params["attn_w"].T, te)
    mask = mask_t.t()
    att_logits = att_logits.masked_fill(~mask, float("-inf"))
    att = torch.softmax(att_logits, dim=-1)
    att = torch.where(mask, att, torch.zeros((), dtype=att.dtype, device=att.device))

    h_final = _run_gru(params["augru"], states_t, mask_t, att.t().contiguous())[-1]

    feats = torch.cat([h_final, te], dim=-1)
    logit = dense_stack(params["mlp"], feats)[:, 0]
    return logit, states_t.transpose(0, 1)


def bce_loss(params, batch, cfg: DIENConfig, mesh=None) -> torch.Tensor:
    """The CTR loss plus DIEN's auxiliary next-behaviour loss; batch needs
    hist, target, labels [B] and aux_neg [B, S] (negative items)."""
    logit, states = forward(params, batch, cfg, mesh)
    y = batch["labels"].to(torch.float32)
    main = batch_mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))), mesh)

    hist = batch["hist"]
    mask = (hist >= 0)[:, 1:]
    e_next = take(params["item_emb"], hist[:, 1:], mesh)
    e_neg = take(params["item_emb"], batch["aux_neg"][:, 1:], mesh)
    h = states[:, :-1] @ params["attn_w"].T              # project g -> d
    pos_s = torch.sum(h * e_next, -1)
    neg_s = torch.sum(h * e_neg, -1)
    aux = -(F.logsigmoid(pos_s) + torch.log1p(-torch.sigmoid(neg_s) + 1e-7))
    aux = batch_ratio(torch.sum(aux * mask), torch.sum(mask), mesh)
    return main + cfg.aux_weight * aux


def user_vector(params, hist: torch.Tensor, cfg: DIENConfig) -> torch.Tensor:
    """The projected state at the last valid position [B, d]: the query of
    the retrieval step."""
    hist_t = hist.t()
    states_t = _run_gru(params["gru1"], take(params["item_emb"], hist_t),
                      hist_t >= 0)
    lengths = torch.clamp(torch.sum(hist >= 0, dim=1) - 1, min=0)
    h_last = states_t[lengths, torch.arange(hist.shape[0], device=hist.device)]
    return h_last @ params["attn_w"].T


def retrieval_scores(params, hist: torch.Tensor, cfg: DIENConfig, candidates=None):
    """MIPS scores [B, N] of the user vector over the items."""
    u = user_vector(params, hist, cfg)
    items = params["item_emb"] if candidates is None else candidates
    return u.float() @ items.float().T

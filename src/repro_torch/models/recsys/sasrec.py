"""SASRec (Kang & McAuley, arXiv:1808.09781): self-attentive sequential
recommendation.  embed_dim=50, 2 blocks, 1 head, seq_len=50.

The tower's output is a user embedding; serving is MIPS over the item
embedding table (``retrieval_cand``: ``mips_topk``), or ip-NSW+ over
``params["item_emb"]``.

``mesh``: a ``DeviceMesh`` under which ``item_emb`` is this rank's row
block over "model" (``table_spec``) and the batch this rank's block over
the batch axes (``embedding.take``, ``batch_ratio``); None, every tensor
whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import P, check_mesh
from repro_torch.models.layers import _dense_init, make_generator, normal
from repro_torch.models.recsys.embedding import batch_ratio, table_spec, take
from repro_torch.train.tree import tree_map


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    n_items: int = 1_000_000
    dropout: float = 0.0              # inference framework: no dropout
    dtype: Any = torch.float32


def init(cfg: SASRecConfig, generator=None, *, device="cuda"):
    """The parameter tree: item and position tables, and per block the
    attention / MLP weights and the two layer-norm gains."""
    g = generator if generator is not None else make_generator(device)
    d = cfg.embed_dim
    params = {
        "item_emb": normal((cfg.n_items, d), g, device, d**-0.5, cfg.dtype),
        "pos_emb": normal((cfg.seq_len, d), g, device, d**-0.5, cfg.dtype),
        "blocks": [],
    }
    for _ in range(cfg.n_blocks):
        blk = {name: _dense_init(g, (d, d), cfg.dtype, device)
               for name in ("wq", "wk", "wv", "w1", "w2")}
        blk["ln1"] = torch.ones((d,), dtype=cfg.dtype, device=device)
        blk["ln2"] = torch.ones((d,), dtype=cfg.dtype, device=device)
        params["blocks"].append(blk)
    return params


def specs(cfg):
    """JAX's spec tree: every leaf replicated but the item table, row-sharded over "model"."""
    s = tree_map(lambda _: P(), init(cfg, device="meta"))
    s["item_emb"] = table_spec()
    return s


def _ln(x, g, eps=1e-6):
    """Population-variance layer norm with a gain and no bias."""
    return F.layer_norm(x, (x.shape[-1],), g, None, eps)


def user_tower(params, hist: torch.Tensor, cfg: SASRecConfig, mesh=None) -> torch.Tensor:
    """hist [B, S] item ids (-1 pad) -> sequence representation [B, S, d]."""
    check_mesh(mesh)
    b, s = hist.shape
    mask = hist >= 0
    x = take(params["item_emb"], hist, mesh)
    x = x * cfg.embed_dim**0.5 + params["pos_emb"][None, :s]
    x = x * mask[..., None].to(x.dtype)

    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=hist.device))
    attn_mask = causal[None] & mask[:, None, :]
    has_key = attn_mask.any(-1, keepdim=True)

    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"])
        q, k, v = h @ blk["wq"], h @ blk["wk"], h @ blk["wv"]
        logits = torch.einsum("bsd,btd->bst", q, k) / cfg.embed_dim**0.5
        logits = logits.masked_fill(~attn_mask, float("-inf"))
        p = torch.softmax(logits, dim=-1)
        # a row with no valid key gives zeros; masked_fill's backward zeroes
        # the NaN its softmax gradient holds, so the gradient stays NaN-free
        p = torch.where(has_key, p, torch.zeros((), dtype=p.dtype, device=p.device)).to(x.dtype)
        x = x + torch.einsum("bst,btd->bsd", p, v)
        h2 = _ln(x, blk["ln2"])
        x = x + F.relu(h2 @ blk["w1"]) @ blk["w2"]
    return x * mask[..., None].to(x.dtype)


def user_embedding(params, hist: torch.Tensor, cfg: SASRecConfig, mesh=None) -> torch.Tensor:
    """The last valid position's representation [B, d]."""
    reps = user_tower(params, hist, cfg, mesh)
    lengths = torch.clamp(torch.sum(hist >= 0, dim=1) - 1, min=0)
    return reps[torch.arange(hist.shape[0], device=hist.device), lengths]


def sampled_softmax_loss(params, batch, cfg: SASRecConfig, mesh=None) -> torch.Tensor:
    """batch = {hist [B, S], pos [B, S], neg [B, S, n_neg]}: per-position
    next-item prediction (the paper's BCE over n_neg negatives)."""
    reps = user_tower(params, batch["hist"], cfg, mesh)           # [B, S, d]
    emb = params["item_emb"]
    pos_e = take(emb, batch["pos"], mesh)
    neg_e = take(emb, batch["neg"], mesh)
    pos_s = torch.sum(reps * pos_e, -1)                           # [B, S]
    neg_s = torch.einsum("bsd,bsnd->bsn", reps, neg_e)
    valid = (batch["pos"] >= 0).to(torch.float32)
    loss = -F.logsigmoid(pos_s) - torch.sum(torch.log1p(-torch.sigmoid(neg_s) + 1e-7), dim=-1)
    return batch_ratio(torch.sum(loss * valid), torch.sum(valid), mesh)


def retrieval_scores(params, hist: torch.Tensor, cfg: SASRecConfig, candidates=None):
    """[B, N] scores of every item (or of the candidate rows): the exact
    scoring path of ``retrieval_cand``."""
    u = user_embedding(params, hist, cfg)
    items = params["item_emb"] if candidates is None else candidates
    return u.float() @ items.float().T

"""MIND (Li et al., arXiv:1904.08030): multi-interest network with dynamic
(B2I capsule) routing.

A user's behaviour sequence is routed into ``n_interests`` capsules; serving
scores an item by the MAX inner product over the interests, so every user
issues ``n_interests`` MIPS queries.

``mesh``: as SASRec's (``item_emb`` this rank's row block over "model", the
batch this rank's block over the batch axes); None, every tensor whole.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.launch.mesh import P, check_mesh
from repro_torch.models.layers import _dense_init, make_generator, normal
from repro_torch.models.recsys.embedding import batch_mean, table_spec, take
from repro_torch.train.tree import tree_map


@dataclasses.dataclass(frozen=True)
class MINDConfig:
    name: str = "mind"
    embed_dim: int = 64
    n_interests: int = 4
    capsule_iters: int = 3
    seq_len: int = 50
    n_items: int = 1_000_000
    label_pow: float = 2.0            # label-aware attention exponent
    dtype: Any = torch.float32


def init(cfg: MINDConfig, generator=None, *, device="cuda"):
    g = generator if generator is not None else make_generator(device)
    d = cfg.embed_dim
    return {
        "item_emb": normal((cfg.n_items, d), g, device, d**-0.5, cfg.dtype),
        "bilinear": _dense_init(g, (d, d), cfg.dtype, device),
        # the routing logits' fixed start (not trained in the paper), kept as
        # a param so that a checkpoint is self-contained
        "routing_init": normal((cfg.seq_len, cfg.n_interests), g, device, 1.0, cfg.dtype),
    }


def specs(cfg):
    """JAX's spec tree: every leaf replicated but the item table, row-sharded over "model"."""
    s = tree_map(lambda _: P(), init(cfg, device="meta"))
    s["item_emb"] = table_spec()
    return s


def _squash(z, eps=1e-9):
    n2 = torch.sum(z * z, dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * z * torch.rsqrt(n2 + eps)


def interest_capsules(params, hist: torch.Tensor, cfg: MINDConfig, mesh=None) -> torch.Tensor:
    """hist [B, S] (-1 pad) -> interests [B, K, d], after ``capsule_iters``
    routing iterations."""
    check_mesh(mesh)
    b, s = hist.shape
    mask = (hist >= 0).to(torch.float32)
    e = take(params["item_emb"], hist, mesh)                               # [B, S, d]
    u_hat = torch.einsum("bsd,de->bse", e, params["bilinear"])       # [B, S, d]
    u_hat = u_hat * mask[..., None]

    blog = params["routing_init"][None, :s].expand(b, s, cfg.n_interests)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(blog, dim=-1)                               # over K
        w = w * mask[..., None]
        z = torch.einsum("bsk,bsd->bkd", w, u_hat)                   # [B, K, d]
        u = _squash(z)
        blog = blog + torch.einsum("bsd,bkd->bsk", u_hat, u)
    return u


def label_aware_user(params, interests, target_emb, cfg: MINDConfig):
    """Label-aware attention (training): interests weighted by
    softmax(p * (u_k . e_t))."""
    sc = torch.einsum("bkd,bd->bk", interests, target_emb)
    w = torch.softmax(cfg.label_pow * sc, dim=-1)
    return torch.einsum("bk,bkd->bd", w, interests)


def sampled_softmax_loss(params, batch, cfg: MINDConfig, mesh=None) -> torch.Tensor:
    """batch = {hist [B, S], pos [B], neg [B, n_neg]}."""
    check_mesh(mesh)
    pos, neg = batch["pos"], batch["neg"]
    if pos.dim() != 1 or neg.dim() != 2:
        # the JAX package's einsum fails on these shapes too (ValueError)
        raise ValueError(f"MIND's loss takes pos [B] and neg [B, n_neg]; got pos "
                         f"{list(pos.shape)} and neg {list(neg.shape)} (SyntheticClickStream "
                         f"gives SASRec's pos [B, S] and neg [B, S, 4])")
    interests = interest_capsules(params, batch["hist"], cfg, mesh)
    emb = params["item_emb"]
    pos_e = take(emb, pos, mesh)                                     # [B, d]
    neg_e = take(emb, neg, mesh)                                     # [B, n, d]
    user = label_aware_user(params, interests, pos_e, cfg)
    pos_s = torch.sum(user * pos_e, -1, keepdim=True)                # [B, 1]
    neg_s = torch.einsum("bd,bnd->bn", user, neg_e)
    logits = torch.cat([pos_s, neg_s], dim=-1)
    return -batch_mean(torch.log_softmax(logits, dim=-1)[:, 0], mesh)


def retrieval_scores(params, hist: torch.Tensor, cfg: MINDConfig, candidates=None):
    """Max-over-interests scores [B, N]: K MIPS queries a user."""
    interests = interest_capsules(params, hist, cfg)                 # [B, K, d]
    items = params["item_emb"] if candidates is None else candidates
    sc = torch.einsum("bkd,nd->bkn", interests.float(), items.float())
    return torch.amax(sc, dim=1)

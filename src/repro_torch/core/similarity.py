"""Similarity functions for proximity-graph construction and search.

  inner product   s(x, y) = x . y                (the MIPS objective)
  angular         s_a(x, y) = x . y / (|x| |y|)  (paper footnote 5)

Angular search over a dataset is inner-product search over the
unit-normalized dataset (for a fixed query, q.x/|x| is monotone in q.x_hat),
so one inner-product walk serves both graphs and the angular graph keeps a
normalized copy of the items.
"""
from __future__ import annotations

import enum

import torch

NEG_INF = float("-inf")


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """int32 keys in the total order of the fp32 scores: +0.0 above -0.0,
    every other pair as the floats compare.  Negative floats have their
    magnitude bits flipped, so larger magnitudes give smaller keys."""
    bits = scores.float().contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def top_l(scores: torch.Tensor, l: int):
    """``lax.top_k``'s order: score descending with +0.0 above -0.0, the
    first occurrence winning exact ties (-inf included).  Returns (values,
    positions) of the first ``l``."""
    idx = torch.sort(order_key(scores), dim=-1, descending=True, stable=True).indices[..., :l]
    return scores.gather(-1, idx), idx


class Similarity(enum.Enum):
    INNER_PRODUCT = "ip"
    ANGULAR = "angular"


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit-normalize rows of ``x`` (norms clamped below at ``eps``)."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / n.clamp_min(eps)


def prepare_items(items: torch.Tensor, sim: Similarity) -> torch.Tensor:
    """Pre-transform the items so that inner product ranks by ``sim``."""
    if sim == Similarity.INNER_PRODUCT:
        return items
    if sim == Similarity.ANGULAR:
        return normalize(items)
    raise ValueError(sim)


def pair_scores(queries: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """[B, d] x [N, d] -> [B, N] fp32 inner products."""
    return queries.float() @ items.float().T


def gather_scores(
    queries: torch.Tensor, items: torch.Tensor, ids: torch.Tensor
) -> torch.Tensor:
    """[B, d], [N, d], [B, W] ids -> [B, W] fp32 inner products.  Ids of -1
    are scored against row 0; the caller masks them."""
    vecs = items[ids.clamp_min(0)]                       # [B, W, d]
    return torch.einsum("bd,bwd->bw", queries.float(), vecs.float())

"""Plain PyTorch version of mips_topk: exact MIPS, ``top_k(q @ items^T)``
per query in ``lax.top_k``'s order (``similarity.top_l``).

With ``scales`` given, ``items`` holds the int8 store's codes and the scores
follow its convention ``(q . codes) * scale`` (``quant_score/ref.py``): the
fp32 product over the cast codes, then one multiply per column."""
from __future__ import annotations

import torch

from repro_torch.core.similarity import pair_scores, top_l


def mips_topk_ref(queries: torch.Tensor, items: torch.Tensor, *, k: int,
                  scales: "torch.Tensor | None" = None):
    """[B, d] x [N, d] -> (scores [B, k] fp32, ids [B, k] int32)."""
    scores = pair_scores(queries, items)
    if scales is not None:
        scores = scores * scales[None, :]
    vals, ids = top_l(scores, k)
    return vals, ids.to(torch.int32)

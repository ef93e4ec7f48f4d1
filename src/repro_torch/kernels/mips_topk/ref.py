"""Plain PyTorch version of mips_topk: exact MIPS, ``top_k(q @ items^T)``
per query by score descending, then item id ascending (``lax.top_k``'s
order, kept by a stable sort)."""
from __future__ import annotations

import torch

from repro_torch.core.similarity import pair_scores, top_l


def mips_topk_ref(queries: torch.Tensor, items: torch.Tensor, *, k: int):
    """[B, d] x [N, d] -> (scores [B, k] fp32, ids [B, k] int32)."""
    vals, ids = top_l(pair_scores(queries, items), k)
    return vals, ids.to(torch.int32)

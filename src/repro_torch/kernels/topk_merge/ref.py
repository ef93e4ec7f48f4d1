"""Plain PyTorch version of topk_merge, ported from the JAX package's
``topk_merge_ref``: concatenate [pool, new], keep the top L in
``lax.top_k``'s order (``similarity.top_l``: score descending, +0.0 above
-0.0, the first occurrence winning exact ties) and gather both payloads.
It defines the semantics that the CUDA kernel (``csrc/topk_merge.cu``) is
held to."""
from __future__ import annotations

import torch

from repro_torch.core.similarity import top_l


def topk_merge_ref(pool_s, pool_i, pool_c, new_s, new_i, new_c):
    """pool_*: [B, L] (fp32 scores, int32 ids, int32 0/1 checked flags);
    new_*: [B, M].  Returns the merged top L (scores, ids, checked)."""
    cand_s = torch.cat([pool_s, new_s], dim=1)
    cand_i = torch.cat([pool_i, new_i], dim=1)
    cand_c = torch.cat([pool_c, new_c], dim=1)
    vals, sel = top_l(cand_s, pool_s.shape[1])
    return vals, cand_i.gather(1, sel), cand_c.gather(1, sel)

"""Plain PyTorch version of quant_score: the int8 store's score convention,
ported from the JAX package's ``quant_score_ref``, and its one definition in
the port:

    s~(q, i) = (q . codes_i) * scales_i    (fp32 dot over the cast codes,
                                            then ONE multiply per score)

Ids of -1 score -inf here (unlike gather_score, whose caller masks): the
quantized seeds and walk both carry -1 padding."""
from __future__ import annotations

import torch

from repro_torch.core.similarity import NEG_INF


def quant_score_ref(
    queries: torch.Tensor,  # [B, d] fp32
    codes: torch.Tensor,    # [N, d] int8
    scales: torch.Tensor,   # [N] fp32
    ids: torch.Tensor,      # [B, W] int32, -1 padded
) -> torch.Tensor:
    """[B, W] fp32 gathered quantized scores; -1 ids give -inf."""
    safe = ids.clamp_min(0).long()
    s = torch.einsum("bd,bwd->bw", queries.float(), codes[safe].float())
    s = s * scales[safe]
    return torch.where(ids >= 0, s, NEG_INF)

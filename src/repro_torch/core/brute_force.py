"""Exact MIPS by linear scan: the ground truth of every recall number and
the paper's exact baseline.  On the card this is the ``mips_topk`` kernel;
on the CPU its plain version, one query tile at a time so that the
``[B, N]`` score matrix never materializes whole."""
from __future__ import annotations

import torch

from repro_torch.kernels.mips_topk import mips_topk


def exact_topk(queries: torch.Tensor, items: torch.Tensor, k: int = 10,
               query_tile: int = 1024):
    """[B, d] x [N, d] -> (scores [B, k] fp32, ids [B, k] int32)."""
    queries = queries.float().contiguous()
    items = items.float().contiguous()
    if queries.device.type == "cuda":
        return mips_topk(queries, items, k=k)
    parts = [mips_topk(queries[s: s + query_tile], items, k=k)
             for s in range(0, queries.shape[0], query_tile)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])

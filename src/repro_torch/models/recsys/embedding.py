"""EmbeddingBag as the JAX package computes it (gather + masked or segment
sums); ids of -1 are padding.

  * padded bags  [B, L] int32 (-1 pad)     -> masked gather + sum / mean
  * ragged bags  flat_ids [T] + offsets [B+1] -> gather + segment sums
    (``searchsorted`` for each element's bag, ``index_add_`` for the sums)

``table_spec`` is JAX's row sharding of a table over "model".
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import MODEL_AXIS, P


def table_spec(stacked: bool = False) -> P:
    """Tables shard by row over "model" (the stacked field tables of DLRM:
    dimension 1)."""
    return P(None, MODEL_AXIS, None) if stacked else P(MODEL_AXIS, None)


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[max(ids, 0)]`` (JAX's ``take(table, maximum(ids, 0))``), its
    gradient a dense scatter-add.  By ``F.embedding``: its backward on the
    card sums a repeated id in parallel segments, where indexing's backward
    gives each id to one warp, and a padded history repeats row 0 once for
    every pad."""
    return F.embedding(ids.clamp_min(0).long(), table)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, mode: str = "sum") -> torch.Tensor:
    """table [V, d]; ids [..., L] int, -1 = padding -> [..., d]."""
    vecs = take(table, ids)                               # [..., L, d]
    mask = (ids >= 0)[..., None].to(vecs.dtype)
    s = torch.sum(vecs * mask, dim=-2)
    if mode == "sum":
        return s
    if mode == "mean":
        cnt = torch.clamp(torch.sum(mask, dim=-2), min=1.0)
        return s / cnt
    raise ValueError(mode)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor, offsets: torch.Tensor,
                         mode: str = "sum") -> torch.Tensor:
    """table [V, d]; flat_ids [T]; offsets [B+1] -> [B, d] (torch
    EmbeddingBag semantics; an element past ``offsets[-1]`` belongs to no
    bag, as ``segment_sum`` drops an out-of-range segment)."""
    b = offsets.shape[0] - 1
    pos = torch.arange(flat_ids.shape[0], device=flat_ids.device, dtype=offsets.dtype)
    seg = torch.searchsorted(offsets[1:].contiguous(), pos, right=True)
    keep = (flat_ids >= 0) & (seg < b)
    seg = seg.clamp_max(max(b - 1, 0))
    vecs = take(table, flat_ids) * keep[:, None].to(table.dtype)
    s = torch.zeros((b, table.shape[1]), dtype=table.dtype, device=table.device)
    s = s.index_add(0, seg, vecs)
    if mode == "sum":
        return s
    if mode == "mean":
        cnt = torch.zeros(b, dtype=table.dtype, device=table.device).index_add(
            0, seg, keep.to(table.dtype))
        return s / torch.clamp(cnt, min=1.0)[:, None]
    raise ValueError(mode)


def multi_table_lookup(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """tables [F, V, d]; ids [B, F], one id a field -> [B, F, d]."""
    f = tables.shape[0]
    return tables[torch.arange(f, device=ids.device)[None, :], ids.clamp_min(0).long()]

"""EmbeddingBag as the JAX package computes it (gather + masked or segment
sums); ids of -1 are padding.

  * padded bags  [B, L] int32 (-1 pad)     -> masked gather + sum / mean
  * ragged bags  flat_ids [T] + offsets [B+1] -> gather + segment sums
    (``searchsorted`` for each element's bag, ``index_add_`` for the sums)

``table_spec`` is JAX's row sharding of a table over "model".  Under a mesh
a rank holds its row block of each table, and a lookup is what JAX's GSPMD
lowers it into: a gather that masks the ids outside the block, then a sum
over "model" (``launch.mesh.sum_out``: forward an all-reduce, backward the
identity, since the loss downstream is the same on every rank of the
group).  One rank holds an id's row, so the sum adds zeros to it: the
lookup equals the unsharded one bit for bit.  ``batch_mean`` and
``batch_ratio`` are the towers' loss reductions over a batch cut over the
mesh's batch axes.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.mesh import (MODEL_AXIS, P, axis_group, batch_axes_of, mean_out,
                                     sum_out)


def table_spec(stacked: bool = False) -> P:
    """Tables shard by row over "model" (the stacked field tables of DLRM:
    dimension 1)."""
    return P(None, MODEL_AXIS, None) if stacked else P(MODEL_AXIS, None)


def _row_block(mesh):
    """(this rank's block index, the "model" group) of a row-sharded table,
    or None: no mesh, or one without a "model" axis (the table is whole)."""
    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return None
    return mesh.get_local_rank(MODEL_AXIS), axis_group(mesh, (MODEL_AXIS,))


def _in_block(ids: torch.Tensor, rows: int, block: int):
    """(local row of each ``max(id, 0)``, 0 where it is outside this rank's
    block [block * rows, (block + 1) * rows); the mask of those inside)."""
    i = ids.clamp_min(0).long() - block * rows
    hit = (i >= 0) & (i < rows)
    return torch.where(hit, i, 0), hit


def take(table: torch.Tensor, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """``table[max(ids, 0)]`` (JAX's ``take(table, maximum(ids, 0))``), its
    gradient a dense scatter-add.  By ``F.embedding``: its backward on the
    card sums a repeated id in parallel segments, where indexing's backward
    gives each id to one warp, and a padded history repeats row 0 once for
    every pad.  Under a mesh ``table`` is this rank's row block (over
    "model"): the masked gather, then the sum over the group."""
    blk = _row_block(mesh)
    if blk is None:
        return F.embedding(ids.clamp_min(0).long(), table)
    i, hit = _in_block(ids, table.shape[0], blk[0])
    return sum_out(F.embedding(i, table).masked_fill(~hit[..., None], 0.0), blk[1])


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


def multi_table_lookup(tables: torch.Tensor, ids: torch.Tensor, mesh=None) -> torch.Tensor:
    """tables [F, V, d]; ids [B, F], one id a field -> [B, F, d].  Under a
    mesh ``tables`` is this rank's block of rows (dimension 1, over
    "model"): the masked gather, then the sum over the group."""
    fields = torch.arange(tables.shape[0], device=ids.device)[None, :]
    blk = _row_block(mesh)
    if blk is None:
        return tables[fields, ids.clamp_min(0).long()]
    i, hit = _in_block(ids, tables.shape[1], blk[0])
    return sum_out(tables[fields, i].masked_fill(~hit[..., None], 0.0), blk[1])


def _batch_group(mesh):
    axes = () if mesh is None else batch_axes_of(mesh)
    return axis_group(mesh, axes) if axes else None


def batch_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``mean(x)`` over the whole batch: under a mesh whose batch axes cut
    the batch into equal blocks, the mean over those ranks of each block's
    mean (``mean_out``: each rank backpropagates its own term, and
    ``grad_mean`` over the same axes completes the gradient)."""
    group = _batch_group(mesh)
    loss = torch.mean(x)
    return loss if group is None else mean_out(loss, group)


def batch_ratio(total: torch.Tensor, count: torch.Tensor, mesh=None) -> torch.Tensor:
    """``total / max(count, 1)`` of sums over the whole batch.  Under a mesh
    ``total`` and ``count`` are this block's sums: the count is summed over
    the batch axes, and each rank's term ``P total / count`` goes through
    ``mean_out``, so the value is the whole batch's ratio and the gradient
    after ``grad_mean`` is its gradient."""
    group = _batch_group(mesh)
    if group is None:
        return total / torch.clamp(count, min=1.0)
    count = sum_out(count.detach(), group)
    return mean_out(total * dist.get_world_size(group) / torch.clamp(count, min=1.0), group)

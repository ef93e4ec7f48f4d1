"""gather_score wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel of ``csrc/gather_score.cu`` or raises.  The drop-in for
``similarity.gather_scores`` that ``beam_search`` scores its f32 seeds and
its int8 rerank with: ids of -1 are scored against row 0 and the caller
masks them.

``gather_score.launches`` counts kernel launches (plain runs do not count);
``gather_score.launches_by_width`` counts them by W, the ids' width."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.gather_score.ref import gather_score_ref


def check_gather_inputs(queries: torch.Tensor, items: torch.Tensor, ids: torch.Tensor) -> None:
    """Raise unless the tensors are what the kernel takes: fp32 queries
    [B, d] and items [N, d], int32 ids [B, W], contiguous, on one device,
    and items starting on a 16-byte boundary where d % 4 == 0 (its rows
    load as float4)."""
    dev = queries.device
    b, d = queries.shape
    _lib.expect(queries, "queries", torch.float32, (b, d), dev)
    _lib.expect(items, "items", torch.float32, (items.shape[0], d), dev)
    _lib.expect(ids, "ids", torch.int32, (b, ids.shape[1]), dev)
    if d % 4 == 0 and items.data_ptr() % 16:
        raise ValueError("items must start on a 16-byte boundary")


def gather_score(
    queries: torch.Tensor,  # [B, d] fp32
    items: torch.Tensor,    # [N, d] fp32
    ids: torch.Tensor,      # [B, W] int32, -1 padded
) -> torch.Tensor:
    """``queries[b] . items[max(id, 0)]`` for every ``id = ids[b, w]``,
    [B, W] fp32.  Equals ``gather_score_ref``."""
    if not _lib.on_cuda(queries):
        return gather_score_ref(queries, items, ids)
    check_gather_inputs(queries, items, ids)
    (b, d), w = queries.shape, ids.shape[1]
    out = torch.empty((b, w), dtype=torch.float32, device=queries.device)
    if b == 0 or w == 0:
        return out
    if d % 4 == 0 and queries.data_ptr() % 16:  # a view may start off the float4 grid
        queries = queries.clone()
    rc = _lib.lib().gather_score_f32(queries.data_ptr(), items.data_ptr(), ids.data_ptr(),
                                     b, w, d, out.data_ptr(), _lib.stream(queries.device))
    _lib.check(rc, "gather_score")
    gather_score.launches += 1
    gather_score.launches_by_width[w] = gather_score.launches_by_width.get(w, 0) + 1
    return out


gather_score.launches = 0
gather_score.launches_by_width = {}

"""gather_score wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel of ``csrc/gather_score.cu`` or raises.  The drop-in for
``similarity.gather_scores`` that ``beam_search`` scores its f32 seeds and
its int8 rerank with: ids of -1 are scored against row 0 and the caller
masks them.

``gather_score.launches`` counts kernel launches (plain runs do not count)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.gather_score.ref import gather_score_ref


def gather_score(
    queries: torch.Tensor,  # [B, d] fp32
    items: torch.Tensor,    # [N, d] fp32
    ids: torch.Tensor,      # [B, W] int32, -1 padded
) -> torch.Tensor:
    """``queries[b] . items[max(id, 0)]`` for every ``id = ids[b, w]``,
    [B, W] fp32.  Equals ``gather_score_ref``."""
    if not _lib.on_cuda(queries):
        return gather_score_ref(queries, items, ids)
    dev = queries.device
    b, d = queries.shape
    n, w = items.shape[0], ids.shape[1]
    _lib.expect(queries, "queries", torch.float32, (b, d), dev)
    _lib.expect(items, "items", torch.float32, (n, d), dev)
    _lib.expect(ids, "ids", torch.int32, (b, w), dev)
    out = torch.empty((b, w), dtype=torch.float32, device=dev)
    if b == 0 or w == 0:
        return out
    rc = _lib.lib().gather_score_f32(queries.data_ptr(), items.data_ptr(), ids.data_ptr(),
                                     b, w, d, out.data_ptr(), _lib.stream(dev))
    _lib.check(rc, "gather_score")
    gather_score.launches += 1
    return out


gather_score.launches = 0

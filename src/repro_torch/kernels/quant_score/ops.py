"""quant_score wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel of ``csrc/quant_score.cu`` or raises.

``quant_score.launches`` counts kernel launches (plain runs do not count);
``quant_score.launches_by_width`` counts them by W, the ids' width."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.quant_score.ref import quant_score_ref


def check_quant_inputs(queries: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
                       ids: torch.Tensor) -> None:
    """Raise unless the tensors are what the kernel takes: fp32 queries
    [B, d], int8 codes [N, d], fp32 scales [N], int32 ids [B, W],
    contiguous, on one device, and codes starting on a 4-byte boundary
    where d % 4 == 0 (its rows load as char4)."""
    dev = queries.device
    b, d = queries.shape
    n = codes.shape[0]
    _lib.expect(queries, "queries", torch.float32, (b, d), dev)
    _lib.expect(codes, "codes", torch.int8, (n, d), dev)
    _lib.expect(scales, "scales", torch.float32, (n,), dev)
    _lib.expect(ids, "ids", torch.int32, (b, ids.shape[1]), dev)
    if d % 4 == 0 and codes.data_ptr() % 4:
        raise ValueError("codes must start on a 4-byte boundary")


def quant_score(
    queries: torch.Tensor,  # [B, d] fp32
    codes: torch.Tensor,    # [N, d] int8
    scales: torch.Tensor,   # [N] fp32
    ids: torch.Tensor,      # [B, W] int32, -1 padded
) -> torch.Tensor:
    """``(queries[b] . codes[id]) * scales[id]`` for every ``id = ids[b, w]``,
    [B, W] fp32; -1 ids give -inf.  Equals ``quant_score_ref``."""
    if not _lib.on_cuda(queries):
        return quant_score_ref(queries, codes, scales, ids)
    check_quant_inputs(queries, codes, scales, ids)
    (b, d), w = queries.shape, ids.shape[1]
    out = torch.empty((b, w), dtype=torch.float32, device=queries.device)
    if b == 0 or w == 0:
        return out
    if d % 4 == 0 and queries.data_ptr() % 16:  # a view may start off the float4 grid
        queries = queries.clone()
    rc = _lib.lib().quant_score_i8(queries.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                                   ids.data_ptr(), b, w, d, out.data_ptr(),
                                   _lib.stream(queries.device))
    _lib.check(rc, "quant_score")
    quant_score.launches += 1
    quant_score.launches_by_width[w] = quant_score.launches_by_width.get(w, 0) + 1
    return out


quant_score.launches = 0
quant_score.launches_by_width = {}

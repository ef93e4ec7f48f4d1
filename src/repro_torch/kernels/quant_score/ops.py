"""quant_score wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel of ``csrc/quant_score.cu`` or raises.

``quant_score.launches`` counts kernel launches (plain runs do not count)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.quant_score.ref import quant_score_ref


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
    dev = queries.device
    b, d = queries.shape
    n, w = codes.shape[0], ids.shape[1]
    _lib.expect(queries, "queries", torch.float32, (b, d), dev)
    _lib.expect(codes, "codes", torch.int8, (n, d), dev)
    _lib.expect(scales, "scales", torch.float32, (n,), dev)
    _lib.expect(ids, "ids", torch.int32, (b, w), dev)
    out = torch.empty((b, w), dtype=torch.float32, device=dev)
    if b == 0 or w == 0:
        return out
    rc = _lib.lib().quant_score_i8(queries.data_ptr(), codes.data_ptr(), scales.data_ptr(),
                                   ids.data_ptr(), b, w, d, out.data_ptr(), _lib.stream(dev))
    _lib.check(rc, "quant_score")
    quant_score.launches += 1
    return out


quant_score.launches = 0

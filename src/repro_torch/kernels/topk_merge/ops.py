"""topk_merge wrapper: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel of ``csrc/topk_merge.cu`` or raises.  Inputs are cast
as the JAX wrapper casts them (scores fp32, ids and flags int32); any batch
size is taken.

``topk_merge.launches`` counts kernel launches (plain runs do not count)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.topk_merge.ref import topk_merge_ref


def topk_merge(
    pool_s: torch.Tensor,  # [B, L] fp32, the pool's scores
    pool_i: torch.Tensor,  # [B, L] int32 ids
    pool_c: torch.Tensor,  # [B, L] int32 0/1 checked flags
    new_s: torch.Tensor,   # [B, M] fp32
    new_i: torch.Tensor,   # [B, M] int32
    new_c: torch.Tensor,   # [B, M] int32
):
    """The top L of [pool, new] by score (``lax.top_k``'s order), as
    (scores [B, L] fp32, ids [B, L] int32, checked [B, L] int32).  Equals
    ``topk_merge_ref``."""
    f32, i32 = torch.float32, torch.int32
    args = [t.to(dtype).contiguous() for t, dtype in zip(
        (pool_s, pool_i, pool_c, new_s, new_i, new_c), (f32, i32, i32, f32, i32, i32))]
    if not _lib.on_cuda(pool_s):
        return topk_merge_ref(*args)
    dev = pool_s.device
    b, l = pool_s.shape
    m = new_s.shape[1]
    for t, name, shape in zip(args, ("pool_s", "pool_i", "pool_c", "new_s", "new_i", "new_c"),
                              [(b, l)] * 3 + [(b, m)] * 3):
        _lib.expect(t, name, t.dtype, shape, dev)
    out_s = torch.empty((b, l), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, l), dtype=torch.int32, device=dev)
    out_c = torch.empty((b, l), dtype=torch.int32, device=dev)
    if b == 0 or l == 0:
        return out_s, out_i, out_c
    rc = _lib.lib().topk_merge_f32(*(t.data_ptr() for t in args), b, l, m, out_s.data_ptr(),
                                   out_i.data_ptr(), out_c.data_ptr(), _lib.stream(dev))
    _lib.check(rc, "topk_merge")
    topk_merge.launches += 1
    return out_s, out_i, out_c


topk_merge.launches = 0

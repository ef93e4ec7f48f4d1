"""flash_attn wrappers: a CPU tensor runs the plain version, a CUDA tensor
launches a kernel of ``csrc/flash_attn.cu`` or raises.  fp32 inputs go to
the fp32-unit kernel, bf16 ones to the tensor-core kernel (wgmma, TMA); q, k
and v of one type, hd in {32, 64, 128, 256}; any sequence lengths (the
Pallas kernel's ``bq`` / ``bk`` tiling knobs are gone).

``flash_attention.launches`` and ``flash_attention.launches_bf16`` count the
fp32 and bf16 kernel launches of both entry points (plain runs do not
count)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

HEAD_DIMS = (32, 64, 128, 256)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q [B, S, H, hd], k and v [B, T, KV, hd] are what a kernel
    of ``csrc/flash_attn.cu`` takes: one type (fp32 or bf16), contiguous, on
    one device, hd in ``HEAD_DIMS``, H a multiple of KV."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention takes float32 or bfloat16, got {q.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    _lib.expect(q, "q", q.dtype, (b, s, h, hd), q.device)
    _lib.expect(k, "k", q.dtype, (b, t, kvh, hd), q.device)
    _lib.expect(v, "v", q.dtype, (b, t, kvh, hd), q.device)


def flash_attention(
    q: torch.Tensor,   # [B, S, H, hd]
    k: torch.Tensor,   # [B, T, KV, hd]
    v: torch.Tensor,   # [B, T, KV, hd]
    *,
    q_offset: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal (``window``: sliding-window) attention forward; query i sits
    at position ``q_offset + i``, head h reads kv head ``h // (H / KV)``.
    Returns [B, S, H, hd] in v's type; equals ``flash_attention_ref``."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    if not _lib.on_cuda(q):
        return flash_attention_ref(q, k, v, q_offset=q_offset, window=window)
    check_kernel_inputs(q, k, v)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    bf16 = q.dtype == torch.bfloat16
    # TMA (bf16) and cp.async (fp32) copy from 16-byte aligned addresses; a
    # view may start elsewhere
    q, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (q, k, v))
    entry = _lib.lib().flash_attn_bf16 if bf16 else _lib.lib().flash_attn_f32
    rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, t, h, kvh, hd,
               1.0 / hd ** 0.5, q_offset, window or 0, out.data_ptr(), _lib.stream(q.device))
    _lib.check(rc, "flash_attention")
    counter = "launches_bf16" if bf16 else "launches"
    setattr(flash_attention, counter, getattr(flash_attention, counter) + 1)
    return out


flash_attention.launches = 0
flash_attention.launches_bf16 = 0


def flash_attention_head(
    q: torch.Tensor,   # [S, hd]
    k: torch.Tensor,   # [T, hd]
    v: torch.Tensor,   # [T, hd]
    *,
    q_offset: int = 0,
    window: Optional[int] = None,
) -> torch.Tensor:
    """One head, [S, hd] in v's type: ``flash_attention`` with B = H = KV =
    1; equals ``flash_attention_head_ref``."""
    return flash_attention(q[None, :, None], k[None, :, None], v[None, :, None],
                           q_offset=q_offset, window=window)[0, :, 0]

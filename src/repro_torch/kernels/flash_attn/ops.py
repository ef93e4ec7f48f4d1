"""flash_attn wrappers: a CPU tensor runs the plain version, a CUDA tensor
launches a kernel of ``csrc/flash_attn.cu`` (forward) or
``csrc/flash_attn_bwd.cu`` (backward) or raises.  The fp32 forward runs on
the fp32 units, the fp32 backward on the tensor cores in 3xTF32 (each
operand split in two tf32 parts, three products a product: fp32's
accuracy), bf16 forward and backward on the tensor cores (wgmma fed by
TMA); q, k and v of one type, hd in {32, 64, 128, 256}; any sequence
lengths (the Pallas kernel's ``bq`` / ``bk`` tiling knobs are gone).

``flash_attention`` is differentiable: when a gradient is needed it runs
``_FlashAttention``, whose forward also writes each row's log-sum-exp and
keeps the fp32 output (bf16: the values its output was rounded from, JAX's
residual), and whose backward is ``flash_attention_bwd`` (the JAX
package's custom VJP, ``models/layers.py: _attend_flash``).
``flash_attention.launches`` and ``launches_bf16`` count the fp32 and bf16
forward launches of both entry points, ``launches_bwd`` and
``launches_bwd_bf16`` the backward's (plain runs do not count).

``forward_cost`` and ``backward_cost`` give a launch's flops and the bytes
it must move (the dry-run's ``_lib.COSTS`` and ``chip_smoke.py``'s bounds)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attn.ref import (
    flash_attention_bwd_ref,
    flash_attention_fwd_ref,
    flash_attention_fwd_residual_ref,
    flash_attention_ref,
)

HEAD_DIMS = (32, 64, 128, 256)
FWD_FLOPS_PER_PAIR = 4   # a (query, key) pair's two hd-long products (s, p v), 2 hd each
BWD_FLOPS_PER_PAIR = 10  # a pair's five hd-long products (s, dp, dq, dk, dv), 2 hd each
TF32_PASSES = 3          # the fp32 backward's 3xTF32: three tf32 products a product


def causal_pairs(s: int, t: int, q_offset: int, window: Optional[int]) -> int:
    """(query, key) pairs inside the causal (and window) mask of S queries
    at positions ``q_offset + i`` over T keys: the work the inputs need."""
    pos = q_offset + np.arange(s)
    hi = np.minimum(pos, t - 1)
    lo = np.zeros_like(pos) if window is None else np.maximum(pos - window + 1, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


def forward_cost(b: int, s: int, t: int, h: int, kvh: int, hd: int, q_offset: int,
                 window: Optional[int], itemsize: int, lse: bool = False,
                 residual: bool = False):
    """(flops, bytes) of one forward launch: q read and out written
    [B, S, H, hd], k and v read [B, T, KV, hd], with ``lse`` the row
    log-sum-exps written [B, H, S] fp32 and with ``residual`` the fp32
    output written [B, S, H, hd] (bf16's residual); 4 hd flops a pair inside
    the mask, for each batch row and head."""
    nbytes = (2 * b * s * h * hd + 2 * b * t * kvh * hd) * itemsize
    nbytes += (b * h * s * 4 if lse else 0) + (b * s * h * hd * 4 if residual else 0)
    return float(FWD_FLOPS_PER_PAIR * hd * causal_pairs(s, t, q_offset, window) * b * h), nbytes


def backward_cost(b: int, s: int, t: int, h: int, kvh: int, hd: int, q_offset: int,
                  window: Optional[int], itemsize: int):
    """(flops, bytes) of one backward launch: q, dout and dq; k, v, dk and
    dv; the fp32 residual and lse read; 10 hd flops a pair inside the mask
    (the fp32 kernel computes each as ``TF32_PASSES`` tf32 products)."""
    nbytes = (3 * b * s * h * hd + 4 * b * t * kvh * hd) * itemsize + b * s * h * hd * 4 \
        + b * h * s * 4
    return float(BWD_FLOPS_PER_PAIR * hd * causal_pairs(s, t, q_offset, window) * b * h), nbytes


def _forward_entry_cost(itemsize: int, dtype: str):
    """A forward entry's cost; its lse and (bf16) residual pointers are None
    unless the launch writes them (a meta tensor's pointer is 0)."""
    def cost(q, k, v, b, s, t, h, kvh, hd, scale, q_offset, window, out, lse, *rest):
        residual = len(rest) == 2 and rest[0] is not None  # bf16: (res, stream)
        return (*forward_cost(b, s, t, h, kvh, hd, q_offset, window or None, itemsize,
                              lse=lse is not None, residual=residual), dtype)
    return cost


def _backward_entry_cost(itemsize: int, dtype: str, passes: int):
    """A backward entry's cost: ``backward_cost``, and the delta buffer
    [B, H, S] fp32 its first pass writes and its two kernels read."""
    def cost(q, k, v, out, dout, lse, b, s, t, h, kvh, hd, scale, q_offset, window, *rest):
        flops, nbytes = backward_cost(b, s, t, h, kvh, hd, q_offset, window or None, itemsize)
        return passes * flops, nbytes + 3 * b * h * s * 4, dtype
    return cost


_lib.COSTS.update(flash_attn_f32=_forward_entry_cost(4, "fp32"),
                  flash_attn_bf16=_forward_entry_cost(2, "bf16"),
                  flash_attn_bwd_f32=_backward_entry_cost(4, "tf32", TF32_PASSES),
                  flash_attn_bwd_bf16=_backward_entry_cost(2, "bf16", 1))


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


def check_bwd_inputs(q, k, v, out, dout, lse) -> None:
    """``check_kernel_inputs``, and out [B, S, H, hd] fp32 (the forward's
    residual, for bf16 too), dout [B, S, H, hd] of q's type, lse [B, H, S]
    fp32, all on q's device and contiguous."""
    check_kernel_inputs(q, k, v)
    b, s, h, _ = q.shape
    _lib.expect(out, "out", torch.float32, q.shape, q.device)
    _lib.expect(dout, "dout", q.dtype, q.shape, q.device)
    _lib.expect(lse, "lse", torch.float32, (b, h, s), q.device)


def _aligned(*xs):
    """TMA (bf16) and cp.async / vector loads copy from 16-byte aligned
    addresses; a view may start elsewhere."""
    return tuple(x if x.data_ptr() % 16 == 0 else x.clone() for x in xs)


def _count(name: str) -> None:
    setattr(flash_attention, name, getattr(flash_attention, name) + 1)


def _forward_kernel(q, k, v, q_offset: int, window: Optional[int], with_lse: bool):
    """One forward launch: out, and with ``with_lse`` (out, lse [B, H, S],
    the fp32 residual: out itself for fp32, for bf16 the fp32 values out
    was rounded from)."""
    check_kernel_inputs(q, k, v)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if with_lse else None
    res = (torch.empty(q.shape, dtype=torch.float32, device=q.device) if bf16 else out) \
        if with_lse else None
    if out.numel() == 0:
        return (out, lse, res) if with_lse else out
    q, k, v = _aligned(q, k, v)
    if bf16:
        rc = _lib.lib().flash_attn_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, t, h, kvh, hd, 1.0 / hd ** 0.5,
            q_offset, window or 0, out.data_ptr(), lse.data_ptr() if with_lse else None,
            res.data_ptr() if with_lse else None, _lib.stream(q.device))
    else:
        rc = _lib.lib().flash_attn_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, t, h, kvh, hd, 1.0 / hd ** 0.5,
            q_offset, window or 0, out.data_ptr(), lse.data_ptr() if with_lse else None,
            _lib.stream(q.device))
    _lib.check(rc, "flash_attention")
    _count("launches_bf16" if bf16 else "launches")
    return (out, lse, res) if with_lse else out


def flash_attention_bwd(q, k, v, out, dout, lse, *, q_offset: int = 0,
                        window: Optional[int] = None):
    """(dq, dk, dv) of ``flash_attention`` from its inputs, its fp32 output
    (bf16 inputs: the forward's fp32 residual), the output's gradient and
    the forward's ``lse`` [B, H, S]; equals ``flash_attention_bwd_ref``
    (bf16: but for p rounded to bf16 before the dv product).  On the card: a
    delta pass, the dK / dV kernel and the dQ kernel of
    ``csrc/flash_attn_bwd.cu`` (fp32: 3xTF32 tensor-core products),
    deterministic (no atomics)."""
    if not _lib.on_cuda(q):
        return flash_attention_bwd_ref(q, k, v, out, dout, lse, q_offset=q_offset, window=window)
    check_bwd_inputs(q, k, v, out, dout, lse)
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    bf16 = q.dtype == torch.bfloat16
    q, k, v, out, dout = _aligned(q, k, v, out, dout)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    entry = _lib.lib().flash_attn_bwd_bf16 if bf16 else _lib.lib().flash_attn_bwd_f32
    rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
               lse.data_ptr(), b, s, t, h, kvh, hd, 1.0 / hd ** 0.5, q_offset, window or 0,
               delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               _lib.stream(q.device))
    _lib.check(rc, "flash_attention_bwd")
    _count("launches_bwd_bf16" if bf16 else "launches_bwd")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """``flash_attention`` with its backward: the forward keeps q, k, v, the
    fp32 output (bf16: the values the output was rounded from) and the row
    log-sum-exps; the backward is ``flash_attention_bwd`` on them.  On the
    CPU both run their plain versions: bf16 ``flash_attention_fwd_residual_ref``
    (the kernel's and JAX's arithmetic, which the residual needs), other
    types ``flash_attention_fwd_ref``."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset: int, window: Optional[int]):
        if _lib.on_cuda(q):
            out, lse, res = _forward_kernel(q, k, v, q_offset, window, with_lse=True)
        elif q.dtype == torch.bfloat16:
            out, lse, res = flash_attention_fwd_residual_ref(q, k, v, q_offset=q_offset,
                                                             window=window)
        else:
            out, lse = flash_attention_fwd_ref(q, k, v, q_offset=q_offset, window=window)
            res = out
        ctx.save_for_backward(q, k, v, res, lse)
        ctx.q_offset, ctx.window = q_offset, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse,
                                         q_offset=ctx.q_offset, window=ctx.window)
        return dq, dk, dv, None, None


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
    Returns [B, S, H, hd] in v's type; equals ``flash_attention_ref``.  An
    input that needs a gradient goes through ``_FlashAttention``."""
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive or None, got {window}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        if _lib.on_cuda(q):
            check_kernel_inputs(q, k, v)
        return _FlashAttention.apply(q, k, v, q_offset, window)
    if not _lib.on_cuda(q):
        return flash_attention_ref(q, k, v, q_offset=q_offset, window=window)
    return _forward_kernel(q, k, v, q_offset, window, with_lse=False)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_offset: int = 0, window: Optional[int] = None):
    """The forward with each row's log-sum-exp, for a partial attention over
    a slice of the keys (a sequence-sharded decode cache; the slices are
    combined by their lse).  Returns (out [B, S, H, hd] fp32: for bf16 the
    values the kernel's bf16 output is rounded from; lse [B, H, S] fp32).
    No gradient.  On the card one forward launch that writes the lse (and
    the bf16 residual), counted as ``flash_attention``'s; on the CPU its
    plain version (bf16: ``flash_attention_fwd_residual_ref``, the kernel's
    arithmetic)."""
    if _lib.on_cuda(q):
        _, lse, res = _forward_kernel(q, k, v, q_offset, window, with_lse=True)
        return res, lse
    if q.dtype == torch.bfloat16:
        _, lse, res = flash_attention_fwd_residual_ref(q, k, v, q_offset=q_offset, window=window)
        return res, lse
    out, lse = flash_attention_fwd_ref(q, k, v, q_offset=q_offset, window=window)
    return out.float(), lse


flash_attention.launches = 0
flash_attention.launches_bf16 = 0
flash_attention.launches_bwd = 0
flash_attention.launches_bwd_bf16 = 0


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

"""Plain PyTorch versions of flash_attn, forward and backward.

The forward is ported from the JAX package's ``flash_attention_head_ref``:
scores ``(q @ k.T)`` in q's type, then fp32, divided by ``sqrt(hd)``; keys
past ``q_offset + i`` (and, with a window, at or before ``q_offset + i -
window``) masked to -inf; softmax; a row with no key in range gives 0;
``(p in v's type) @ v`` in v's type.  It defines the semantics that the CUDA
kernel (``csrc/flash_attn.cu``) is held to.  ``flash_attention_fwd_ref``
also returns each row's log-sum-exp, the statistic the backward recomputes
the softmax from.  ``flash_attention_fwd_residual_ref`` is the training
forward on bf16: JAX's ``_flash_fwd_scan`` arithmetic (the unnormalised p
rounded to v's type, divided by l after the product), which the bf16
kernel has too, with its fp32 output kept for the backward's delta.

The backward (``flash_attention_bwd_ref``) is the JAX package's
FlashAttention backward (``models/layers.py: _attend_flash_bwd``) with its
casts: ``do`` in fp32 and ``delta = sum(do * out)``; scores ``q . k`` in
fp32 times ``1 / sqrt(hd)``; ``p = exp(s - lse)``; ``dp = do . v``;
``ds = p (dp - delta)``, rounded to q's type before the dq and dk products;
dv from fp32 ``p`` and ``do``; dk and dv summed over the query heads of a
kv head.  JAX keeps the pair (m, l) a row and forms ``p = exp(s - m) / l``;
here one fp32 ``lse = m + log l`` does, ``p = exp(s - lse)``, which changes
only the rounding (within the fp32 tests' 2e-5).  It loops over kv chunks
as JAX's scan does, so no [S, T] matrix is built whole.  It defines what
``csrc/flash_attn_bwd.cu`` computes; the bf16 kernels' products take bf16
operands, so they round p to bf16 before the dv product, one rounding this
version does not have; the fp32 kernels split every operand in two tf32
parts (3xTF32), within about 2^-22 of a product.  ``out`` is read as fp32:
the training forward's residual, for bf16 too.
"""
from __future__ import annotations

from typing import Optional

import torch


def _mask(s: int, t0: int, t1: int, q_offset: int, window: Optional[int], device):
    """[S, t1 - t0] bool: query i sees key t."""
    qi = q_offset + torch.arange(s, device=device)[:, None]
    ki = torch.arange(t0, t1, device=device)[None, :]
    ok = ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return ok


def _attention_ref(q, k, v, *, q_offset: int = 0, window: Optional[int] = None,
                   with_lse: bool = False):
    """The reference over leading batch dims: q [..., S, hd], k / v
    [..., T, hd].  Returns out in v's type, with ``with_lse`` (out, lse
    [..., S] fp32)."""
    s, hd = q.shape[-2:]
    t = k.shape[-2]
    logits = (q @ k.transpose(-1, -2)).float() / hd ** 0.5
    ok = _mask(s, 0, t, q_offset, window, q.device)
    logits = logits.masked_fill(~ok, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    p = torch.where(ok.any(dim=-1, keepdim=True), p, 0.0)
    out = (p.to(v.dtype) @ v).to(v.dtype)
    return (out, torch.logsumexp(logits, dim=-1)) if with_lse else out


def flash_attention_head_ref(q, k, v, *, q_offset: int = 0, window: Optional[int] = None):
    """One head: q [S, hd], k / v [T, hd] -> [S, hd] in v's type."""
    return _attention_ref(q, k, v, q_offset=q_offset, window=window)


def _grouped(q, k, v, q_offset, window, with_lse):
    g = q.shape[2] // k.shape[2]
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2)
    return _attention_ref(q.transpose(1, 2), kh, vh, q_offset=q_offset, window=window,
                          with_lse=with_lse)


def flash_attention_fwd_ref(q, k, v, *, q_offset: int = 0, window: Optional[int] = None):
    """Grouped-query heads: q [B, S, H, hd], k / v [B, T, KV, hd] -> (out
    [B, S, H, hd] in v's type, lse [B, H, S] fp32, -inf for a row with no
    key); head h reads kv head h // (H / KV), as the JAX wrapper's
    ``reshape(b, s, kv, g, hd)`` groups them."""
    out, lse = _grouped(q, k, v, q_offset, window, True)
    return out.transpose(1, 2).contiguous(), lse


def flash_attention_fwd_residual_ref(q, k, v, *, q_offset: int = 0,
                                     window: Optional[int] = None):
    """The training forward's arithmetic, JAX's ``_flash_fwd_scan`` at one kv
    chunk and the bf16 kernel's: fp32 scores (exact products of the
    inputs, fp32 sums) times ``1 / sqrt(hd)``, m the row max, p = exp(s - m)
    rounded to v's type, fp32 sums with v, divided by max(l, 1e-30), l the
    sum of the fp32 p.  Returns (out in v's type, lse = m + log l [B, H, S],
    the fp32 values out was rounded from: the backward's residual).  A row
    with no key is 0 (lse -inf), as ``flash_attention_fwd_ref`` has it."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qh = q.float().transpose(1, 2)                                     # [B, H, S, hd]
    kh, vh = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    logits = (qh @ kh.float().transpose(-1, -2)) * _attention_scale(hd)
    ok = _mask(s, 0, t, q_offset, window, q.device)
    logits = logits.masked_fill(~ok, float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    res = (p.to(v.dtype).float() @ vh.float()) / l.clamp_min(1e-30)
    lse = (m + torch.log(l)).squeeze(-1)
    res = res.transpose(1, 2).contiguous()
    return res.to(v.dtype), lse, res


def flash_attention_ref(q, k, v, *, q_offset: int = 0, window: Optional[int] = None):
    """``flash_attention_fwd_ref``'s output alone: [B, S, H, hd]."""
    return _grouped(q, k, v, q_offset, window, False).transpose(1, 2).contiguous()


def _attention_scale(hd: int) -> float:
    """``1 / sqrt(hd)`` as JAX's backward forms it, in fp32."""
    return float(torch.tensor(float(hd)).sqrt().reciprocal())


def flash_attention_bwd_ref(q, k, v, out, dout, lse, *, q_offset: int = 0,
                            window: Optional[int] = None, kv_chunk: int = 512):
    """(dq, dk, dv) of ``flash_attention`` given its inputs, its output
    ``out`` [B, S, H, hd], the output's gradient ``dout`` and ``lse`` [B, H,
    S]; each in its input's type and layout.  ``kv_chunk`` keys a step."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = _attention_scale(hd)

    def heads(x):  # [B, S, H, hd] -> [B, KV, G, S, hd] fp32
        return x.float().view(b, s, kvh, g, hd).permute(0, 2, 3, 1, 4)

    qf, do = heads(q), heads(dout)
    delta = torch.sum(do * heads(out), dim=-1)          # [B, KV, G, S]
    lse = lse.reshape(b, kvh, g, s)
    dq = torch.zeros((b, kvh, g, s, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for t0 in range(0, t, kv_chunk):
        t1 = min(t, t0 + kv_chunk)
        kc = k[:, t0:t1].float().transpose(1, 2)         # [B, KV, c, hd]
        vc = v[:, t0:t1].float().transpose(1, 2)
        logits = torch.einsum("bngsh,bnth->bngst", qf, kc) * scale
        ok = _mask(s, t0, t1, q_offset, window, q.device)
        p = torch.where(ok, torch.exp(logits - lse[..., None]), 0.0)
        dp = torch.einsum("bngsh,bnth->bngst", do, vc)
        ds = (p * (dp - delta[..., None])).to(q.dtype).float()
        dq += torch.einsum("bngst,bnth->bngsh", ds, kc) * scale
        dks.append(torch.einsum("bngst,bngsh->bnth", ds, qf) * scale)
        dvs.append(torch.einsum("bngst,bngsh->bnth", p, do))
        del logits, p, dp, ds
    dq = dq.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd).to(q.dtype)
    if t == 0:
        return dq, torch.zeros_like(k), torch.zeros_like(v)
    dk = torch.cat(dks, dim=2).transpose(1, 2).to(k.dtype).contiguous()
    dv = torch.cat(dvs, dim=2).transpose(1, 2).to(v.dtype).contiguous()
    return dq, dk, dv

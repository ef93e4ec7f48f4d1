"""Plain PyTorch version of flash_attn, ported from the JAX package's
``flash_attention_head_ref``: scores ``(q @ k.T)`` in q's type, then fp32,
divided by ``sqrt(hd)``; keys past ``q_offset + i`` (and, with a window, at or
before ``q_offset + i - window``) masked to -inf; softmax; a row with no key
in range gives 0; ``(p in v's type) @ v`` in v's type.  It defines the
semantics that the CUDA kernel (``csrc/flash_attn.cu``) is held to."""
from __future__ import annotations

from typing import Optional

import torch


def _attention_ref(q, k, v, *, q_offset: int = 0, window: Optional[int] = None):
    """The reference over leading batch dims: q [..., S, hd], k / v
    [..., T, hd]."""
    s, hd = q.shape[-2:]
    t = k.shape[-2]
    logits = (q @ k.transpose(-1, -2)).float() / hd ** 0.5
    qi = q_offset + torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    ok = ki <= qi
    if window is not None:
        ok &= ki > qi - window
    p = torch.softmax(logits.masked_fill(~ok, float("-inf")), dim=-1)
    p = torch.where(ok.any(dim=-1, keepdim=True), p, 0.0)
    return (p.to(v.dtype) @ v).to(v.dtype)


def flash_attention_head_ref(q, k, v, *, q_offset: int = 0, window: Optional[int] = None):
    """One head: q [S, hd], k / v [T, hd] -> [S, hd] in v's type."""
    return _attention_ref(q, k, v, q_offset=q_offset, window=window)


def flash_attention_ref(q, k, v, *, q_offset: int = 0, window: Optional[int] = None):
    """Grouped-query heads: q [B, S, H, hd], k / v [B, T, KV, hd] -> [B, S,
    H, hd]; head h reads kv head h // (H / KV), as the JAX wrapper's
    ``reshape(b, s, kv, g, hd)`` groups them."""
    g = q.shape[2] // k.shape[2]
    kh = k.repeat_interleave(g, dim=2).transpose(1, 2)
    vh = v.repeat_interleave(g, dim=2).transpose(1, 2)
    out = _attention_ref(q.transpose(1, 2), kh, vh, q_offset=q_offset, window=window)
    return out.transpose(1, 2).contiguous()

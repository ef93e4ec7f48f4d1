"""Shared layers, the JAX package's ``models/layers.py``: initializers, the
dense MLP stack of the recsys towers, and the transformer's RMSNorm, rotary
embedding, grouped-query attention (train / prefill, and decode on a
ring-buffer cache) and SwiGLU MLP, with JAX's mesh pieces: the batch axes
(``BATCH_AXES``, ``set_batch_axes``, ``batch_axes``,
``set_batch_axes_for_mesh``), the activation hint ``shard`` and the
PartitionSpec trees ``attention_specs`` and ``mlp_specs``.  The port places
tensors explicitly (``launch.mesh.local_shard``), so ``shard`` resolves
JAX's spec and returns its input: JAX's hint never changes a value.

Under a mesh (``attention`` / ``mlp(..., mesh=)``) the weights are this
rank's shards of ``attention_specs`` / ``mlp_specs``, and the layer does
what JAX's GSPMD lowers those specs into.  The FSDP axes (every mesh
axis but the tensor-parallel one) are gathered just in time (``gathered``,
``launch.mesh.gather_param``; backward a reduce-scatter), inside the
caller's checkpointed cycle, so the recompute gathers again.  The
tensor-parallel axis (``model_axis``: "model" where ``resolve_spec`` keeps
it, None under pure FSDP, where "model" carries batch) stays cut: Megatron.
The input enters through ``copy_in`` over "model", each rank computes its
q heads (and the kv heads they read, ``kv_heads``) or its ``d_ff`` columns,
and ``sum_out`` over "model" follows ``wo`` / ``w_out``.  k and v are
projected for every kv head, as JAX's replicated ``wk`` / ``wv`` give
them (the caches hold them all); ``wk`` and ``wv`` enter through
``copy_in`` too, each rank's gradient covering only its kv heads' share.

A decode step under a mesh reads a sequence-sharded cache: rank r of the
cache's axes holds slots [r t_loc, (r + 1) t_loc) of every cache (ring
layers too), the new token's slot is written by its owner, q is gathered
over "model" (a rank needs every head of its slice), ``slice_attention``
runs the ``flash_attn`` forward over the rank's slice with its row
log-sum-exp, ``combine_slices`` merges the slices over the cache's axes in
fp32, and the rank's heads go through its ``wo``: the partial reductions
GSPMD makes of JAX's masked softmax over a sharded sequence.

Attention runs on ``kernels.flash_attn.flash_attention``: the CUDA kernel
(fp32, or bf16 on the tensor cores) for tensors on the card, its plain
version for tensors on the CPU; where a gradient is needed, with its
backward kernel.  JAX's query chunking (``attn_chunk``) and
its flash / dense-block switch only change the order of a sum, so they do
not carry over.

Random draws come from an explicit ``torch.Generator``: the draw happens on
the generator's device and the result moves to ``device``, so a CPU
generator gives the same initial values to a CPU and a card run.  On the
``meta`` device nothing is drawn (shapes only).  The values are the port's
own, not JAX's: parity tests carry JAX's arrays across
(``repro_torch.convert.params_from_arrays``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attn import flash_attention, flash_attention_lse
from repro_torch.launch.mesh import (MODEL_AXIS, P, axis_group, axis_size, copy_in, gather_param,
                                     gather_rows, max_out, sum_out)

BATCH_AXES = ("pod", "data")

# The batch ("data-parallel") axes depend on the mesh: ("pod", "data") on the
# multi-pod mesh, ("data",) on a single pod, ("data", "model") for pure-FSDP
# dense training.  The cells set them; "batch" in a spec resolves to them,
# and an LM loss under a mesh is averaged over them.
_BATCH_AXES = BATCH_AXES


def set_batch_axes(axes) -> None:
    global _BATCH_AXES
    _BATCH_AXES = tuple(axes)


def batch_axes() -> tuple:
    return _BATCH_AXES


def set_batch_axes_for_mesh(mesh) -> None:
    set_batch_axes(tuple(a for a in mesh.mesh_dim_names if a != MODEL_AXIS))


def resolve_spec(*spec) -> P:
    """JAX's ``shard`` resolution: "batch" becomes the batch axes; in pure
    FSDP ("model" among the batch axes) a standalone "model" entry becomes
    None, there being no tensor-parallel activation axis."""
    fsdp = MODEL_AXIS in _BATCH_AXES
    resolved = []
    for s in spec:
        if s == "batch":
            resolved.append(_BATCH_AXES)
        elif fsdp and (s == MODEL_AXIS or (isinstance(s, tuple) and MODEL_AXIS in s)):
            resolved.append(None)
        else:
            resolved.append(s)
    return P(*resolved)


def shard(x: torch.Tensor, *spec) -> torch.Tensor:
    """JAX's activation sharding hint: ``x`` unchanged (``resolve_spec``
    gives the spec JAX would constrain it to)."""
    return x


def model_axis(mesh) -> Optional[str]:
    """The tensor-parallel axis of a layer under ``mesh``: "model" where the
    mesh has it and ``resolve_spec`` keeps it (not among the batch axes),
    None without a mesh or under pure FSDP."""
    if mesh is None or MODEL_AXIS not in mesh.mesh_dim_names:
        return None
    return resolve_spec(MODEL_AXIS)[0]


def gathered(w: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """A weight held as ``spec``'s shard, as the layer uses it: whole along
    the FSDP axes (every mesh axis but the tensor-parallel one), its
    tensor-parallel cut kept (``w`` itself without a mesh)."""
    if mesh is None:
        return w
    tp = model_axis(mesh)
    return gather_param(w, spec, mesh, tuple(a for a in mesh.mesh_dim_names if a != tp))


def tp_group(mesh):
    """(the "model" group, this rank's index in it, its size) when "model"
    is tensor-parallel under ``mesh``, else None."""
    tp = model_axis(mesh)
    if tp is None:
        return None
    return axis_group(mesh, (tp,)), mesh.get_local_rank(tp), axis_size(mesh, (tp,))


def make_generator(device="cuda", seed: int = 0) -> Optional[torch.Generator]:
    """A generator seeded with ``seed`` on ``device`` (None for meta)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def normal(shape, generator: Optional[torch.Generator], device, scale: float = 1.0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``N(0, 1) * scale`` in fp32, cast to ``dtype``, on ``device``."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype).to(device)


def _dense_init(generator, shape, dtype, device, scale: Optional[float] = None):
    """``N(0, 1) * fan_in**-0.5`` with JAX's ``fan_in = shape[-2]``: for
    ``wq [d, H, hd]`` that is H, not d (a property of the reference)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal(shape, generator, device, scale if scale is not None else fan_in**-0.5, dtype)


def dense_stack_init(generator, dims: Sequence[int], dtype=torch.float32, device="cuda"):
    """dims = [in, h1, ..., out] -> a list of {"w", "b"} layers."""
    return [{"w": _dense_init(generator, (dims[i], dims[i + 1]), dtype, device),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=device)}
            for i in range(len(dims) - 1)]


def dense_stack(layers, x: torch.Tensor, act: Callable = F.relu,
                final_act: bool = False) -> torch.Tensor:
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# the transformer's layers
# ---------------------------------------------------------------------------


VJP_COLS = 1 << 15  # columns of ``b`` a step of matmul_f32_vjp (its fp32 copies)


def matmul_f32_vjp(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor):
    """The VJP of ``matmul_f32`` at ``a [n, k]``, ``b [k, m]`` for the fp32
    cotangent ``g [n, m]``, as JAX transposes a product with
    ``preferred_element_type=jnp.float32``: fp32 products of ``g`` with the
    upcast operands, each result rounded once to its operand's type.  The
    products go in steps of VJP_COLS columns of ``b``, so the fp32 copies of
    ``b`` and of its gradient stay that wide (gemma's tied 262,144-row
    embedding would take 4 GB each); ``dx`` sums the steps in fp32."""
    af = a.float()
    dx = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    db = torch.empty_like(b)
    for j in range(0, b.shape[1], VJP_COLS):
        gj = g[:, j:j + VJP_COLS]
        dx.addmm_(gj, b[:, j:j + VJP_COLS].float().T)
        db[:, j:j + VJP_COLS] = af.T @ gj
    return dx.to(a.dtype), db


class _MatmulF32(torch.autograd.Function):
    """bf16 ``a [n, k] @ b [k, m]`` on the card as one bf16 GEMM with an fp32
    output (``torch.mm(out_dtype=)``, which has no derivative of its own);
    its backward is ``matmul_f32_vjp``: the fp32 cotangent is not rounded
    to bf16 before the products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        return matmul_f32_vjp(*ctx.saved_tensors, g)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., k] @ b [k, n]`` accumulated and returned in fp32 (JAX's
    ``preferred_element_type=jnp.float32``): bf16 operands on the card by
    one bf16 GEMM with an fp32 output (and in the dry-run's trace of the
    card, ``kernels._lib.on_card``), elsewhere in fp32."""
    if _lib.on_card(a) and a.dtype == b.dtype == torch.bfloat16:
        return _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b).view(*a.shape[:-1], b.shape[-1])
    return a.float() @ b.float()


def rmsnorm_init(d: int, dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    h = x.float()
    h = h * torch.rsqrt(torch.mean(h * h, dim=-1, keepdim=True) + eps)
    return (h * g.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: [..., S] int.  The frequencies are
    ``theta ** (-i / half)`` rounded once from float64: the fp32 values
    XLA's ``pow`` gives (torch's fp32 ``pow`` is an ulp off for some i, and
    at position 32,768 an ulp of a frequency moves an angle by 2e-3)."""
    hd = x.shape[-1]
    half = hd // 2
    expo = (torch.arange(0, half, dtype=torch.float32, device=x.device) / half).double()
    freq = (theta ** -expo).float()
    ang = positions[..., :, None, None].float() * freq  # [.., S, 1, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def attention_specs():
    """2-D sharding: the q heads and the output projection's head axis over
    "model"; d_model FSDP-cut over "data" for storage (kv projections over
    "data" only: n_kv <= 8 < the model axis)."""
    return {
        "wq": P("data", MODEL_AXIS, None),
        "wk": P("data", None, None),
        "wv": P("data", None, None),
        "wo": P(MODEL_AXIS, None, "data"),
    }


def attention_init(generator, d_model, n_heads, n_kv, head_dim, dtype=torch.bfloat16,
                   device="cuda"):
    return {
        "wq": _dense_init(generator, (d_model, n_heads, head_dim), dtype, device),
        "wk": _dense_init(generator, (d_model, n_kv, head_dim), dtype, device),
        "wv": _dense_init(generator, (d_model, n_kv, head_dim), dtype, device),
        "wo": _dense_init(generator, (n_heads, head_dim, d_model), dtype, device),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dnh->bsnh")`` as one matrix product."""
    d, n, h = w.shape
    return (x @ w.reshape(d, n * h)).view(*x.shape[:-1], n, h)


def kv_heads(n_heads: int, n_kv: int, ranks: int, rank: int) -> tuple:
    """The kv heads [lo, hi) that q heads [rank H / P, (rank + 1) H / P)
    read (head h reads kv head h // (H / KV)).  Raises unless the heads
    divide over the ranks and a rank's heads are whole groups or lie
    inside one group: then they read a contiguous run of kv heads, each by
    the same number of heads, as the kernel groups them."""
    if n_heads % ranks or n_heads % n_kv:
        raise ValueError(f"{n_heads} q heads over {n_kv} kv heads do not divide over "
                         f"{ranks} model ranks")
    local, group = n_heads // ranks, n_heads // n_kv
    if local % group and group % local:
        raise ValueError(f"{local} q heads a rank of groups of {group} do not map onto whole "
                         f"kv heads")
    return rank * local // group, ((rank + 1) * local - 1) // group + 1


def slice_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, q_offset: int):
    """One cache slice's part of a decode step: (o [B, S, H, hd] fp32, lse
    [B, H, S] fp32) of q over the slice's keys 0..``q_offset`` (the
    slice-local causal offset, a host int, clamped to the slice), by
    ``flash_attention_lse``.  A slice with no valid key (``q_offset`` < 0)
    launches nothing: o 0, lse -inf."""
    b, s, h, hd = q.shape
    t = ck.shape[1]
    if q_offset < 0 or t == 0:
        return (torch.zeros((b, s, h, hd), dtype=torch.float32, device=q.device),
                torch.full((b, h, s), float("-inf"), dtype=torch.float32, device=q.device))
    return flash_attention_lse(q, ck, cv, q_offset=min(q_offset, t - 1))


def combine_slices(o: torch.Tensor, lse: torch.Tensor, group=None) -> torch.Tensor:
    """Attention over keys cut in slices, from each slice's
    ``slice_attention``: ``o`` [n, B, S, H, hd] and ``lse`` [n, B, H, S] of
    the n slices this process holds, ``group`` the ranks holding the others
    (None: none).  With m the max over every slice of lse, the sum of
    e^(lse - m) o over the sum of e^(lse - m), in fp32: [B, S, H, hd]."""
    m = lse.amax(dim=0)
    if group is not None:
        m = max_out(m, group)
    m = torch.where(torch.isfinite(m), m, 0.0)
    w = torch.exp(lse - m)
    num = (w.transpose(-1, -2)[..., None] * o).sum(dim=0)
    den = w.sum(dim=0)
    if group is not None:
        num, den = sum_out(num, group), sum_out(den, group)
    return num / den.transpose(-1, -2)[..., None]


def _decode(q, k, v, kv_cache, q_offset: int, mesh, cache_axes, tp):
    """The attention of one new token over its cache, the token's k / v
    written in place first (module docstring)."""
    if q.shape[1] != 1:
        raise ValueError(f"decode takes one token at a time, got S = {q.shape[1]}")
    ck, cv = kv_cache
    t_loc = ck.shape[1]
    if mesh is None:
        slot = q_offset % t_loc
        ck[:, slot:slot + 1].copy_(k)
        cv[:, slot:slot + 1].copy_(v)
        return flash_attention(q.to(ck.dtype), ck, cv, q_offset=min(q_offset, t_loc - 1))
    group = axis_group(mesh, cache_axes) if cache_axes else None
    r, n = (dist.get_rank(group), dist.get_world_size(group)) if group else (0, 1)
    t = t_loc * n
    slot = q_offset % t - r * t_loc
    if 0 <= slot < t_loc:
        ck[:, slot:slot + 1].copy_(k)
        cv[:, slot:slot + 1].copy_(v)
    if tp is not None:
        q = gather_rows(q, tp[0], dim=2)
    o, lse = slice_attention(q.to(ck.dtype), ck, cv, min(q_offset, t - 1) - r * t_loc)
    ctx = combine_slices(o[None], lse[None], group).to(ck.dtype)
    if tp is not None:
        local = q.shape[2] // tp[2]
        ctx = ctx[:, :, tp[1] * local:(tp[1] + 1) * local]
    return ctx


def attention(params, x: torch.Tensor, positions: torch.Tensor, *, n_kv: int,
              window: Optional[int] = None, kv_cache: Optional[tuple] = None,
              q_offset: int = 0, rope_theta: float = 10000.0, mesh=None,
              cache_axes: Sequence[str] = (MODEL_AXIS,)):
    """x: [B, S, d].  Returns (out [B, S, d], (k, v)).

    Train / prefill (``kv_cache=None``): ``positions`` is ``arange(S)``;
    one ``flash_attention`` over the sequence, causal (``window``: sliding).

    Decode: ``kv_cache=(k, v)`` [B, T, n_kv, hd], S = 1, ``q_offset`` the
    new token's absolute position (a host int).  The token's k / v are
    written into the cache in place at slot ``q_offset % T`` and the cache
    is returned.  If T is smaller than the context (sliding-window layers)
    the cache is a ring: slot s holds position ``q_offset - ((q_offset - s)
    mod T)``, and JAX's mask keeps the slots whose position is in
    ``[max(0, q_offset - window + 1), q_offset]``.  With ``T = cache_len <=
    window`` those are exactly the slots ``s <= min(q_offset, T - 1)``, so
    the kernel's causal mask at ``q_offset = min(q_offset, T - 1)``, with no
    window, computes the same function for global and sliding layers,
    before and after the ring wraps.

    Under ``mesh`` the weights are this rank's shards (module docstring);
    a decode cache is this rank's slice of T along ``cache_axes`` (JAX's
    ``cache_specs`` seq; rank r of them holds slots [r T / n, (r + 1) T /
    n)), and the (k, v) returned for a prefill hold every kv head.
    """
    b, s, _ = x.shape
    spec = attention_specs()
    w = {name: gathered(params[name], spec[name], mesh) for name in spec}
    local, hd = w["wq"].shape[1:]
    tp = tp_group(mesh)
    lo, hi = 0, n_kv
    if tp is not None:
        lo, hi = kv_heads(local * tp[2], n_kv, tp[2], tp[1])
        x = copy_in(x, tp[0])
        w["wk"], w["wv"] = copy_in(w["wk"], tp[0]), copy_in(w["wv"], tp[0])
    q = rope(_project(x, w["wq"]), positions, rope_theta)
    k = rope(_project(x, w["wk"]), positions, rope_theta)
    v = _project(x, w["wv"])

    if kv_cache is not None:
        ctx = _decode(q, k, v, kv_cache, q_offset, mesh, cache_axes, tp)
        k, v = kv_cache
    elif (lo, hi) == (0, n_kv):
        ctx = flash_attention(q, k, v, q_offset=0, window=window)
    else:
        ctx = flash_attention(q, k[:, :, lo:hi].contiguous(), v[:, :, lo:hi].contiguous(),
                              q_offset=0, window=window)
    out = ctx.reshape(b, s, local * hd).to(x.dtype) @ w["wo"].reshape(local * hd, -1)
    return (out if tp is None else sum_out(out, tp[0])), (k, v)


def mlp_specs():
    """Megatron TP on the ffn dim, FSDP storage on d_model."""
    return {
        "w_gate": P("data", MODEL_AXIS),
        "w_in": P("data", MODEL_AXIS),
        "w_out": P(MODEL_AXIS, "data"),
    }


def mlp_init(generator, d_model, d_ff, dtype=torch.bfloat16, device="cuda"):
    return {
        "w_gate": _dense_init(generator, (d_model, d_ff), dtype, device),
        "w_in": _dense_init(generator, (d_model, d_ff), dtype, device),
        "w_out": _dense_init(generator, (d_ff, d_model), dtype, device),
    }


# rows of an [n, d_ff] intermediate the MLPs hold at once (about 1 GiB of
# fp32): a 32k-token prefill runs the MLP in row chunks, each row's values
# unchanged
FFN_CHUNK_VALUES = 1 << 28


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ w_gate) * (x @ w_in)) @ w_out``, SiLU in fp32 and cast
    back (x [n, d], or [E, n, d] with per-expert weights)."""
    h = F.silu((x @ w_gate).float()).to(x.dtype) * (x @ w_in)
    return h @ w_out


def mlp(params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The SwiGLU MLP over [B, S, d], in row chunks of FFN_CHUNK_VALUES;
    under ``mesh`` over this rank's shards (module docstring)."""
    spec = mlp_specs()
    w_gate, w_in, w_out = (gathered(params[name], spec[name], mesh)
                           for name in ("w_gate", "w_in", "w_out"))
    tp = tp_group(mesh)
    if tp is not None:
        x = copy_in(x, tp[0])
    x2d = x.reshape(-1, x.shape[-1])
    rows = max(1, FFN_CHUNK_VALUES // w_gate.shape[-1])
    if x2d.shape[0] <= rows:
        out = swiglu(x2d, w_gate, w_in, w_out).view(x.shape)
    else:
        out = torch.empty_like(x2d)
        for i in range(0, x2d.shape[0], rows):
            out[i:i + rows] = swiglu(x2d[i:i + rows], w_gate, w_in, w_out)
        out = out.view(x.shape)
    return out if tp is None else sum_out(out, tp[0])

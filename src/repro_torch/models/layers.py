"""Shared layers, the JAX package's ``models/layers.py``: initializers, the
dense MLP stack of the recsys towers, and the transformer's RMSNorm, rotary
embedding, grouped-query attention (train / prefill, and decode on a
ring-buffer cache) and SwiGLU MLP, with JAX's mesh pieces: the batch axes
(``BATCH_AXES``, ``set_batch_axes``, ``batch_axes``,
``set_batch_axes_for_mesh``), the activation hint ``shard`` and the
PartitionSpec trees ``attention_specs`` and ``mlp_specs``.  The port places
tensors explicitly (``launch.mesh.local_shard``), so ``shard`` resolves
JAX's spec and returns its input: JAX's hint never changes a value.

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
import torch.nn.functional as F

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.launch.mesh import MODEL_AXIS, P

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


def attention(params, x: torch.Tensor, positions: torch.Tensor, *, n_kv: int,
              window: Optional[int] = None, kv_cache: Optional[tuple] = None,
              q_offset: int = 0, rope_theta: float = 10000.0):
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
    """
    b, s, _ = x.shape
    h, hd = params["wq"].shape[1:]
    q = rope(_project(x, params["wq"]), positions, rope_theta)
    k = rope(_project(x, params["wk"]), positions, rope_theta)
    v = _project(x, params["wv"])

    if kv_cache is not None:
        if s != 1:
            raise ValueError(f"decode takes one token at a time, got S = {s}")
        ck, cv = kv_cache
        t = ck.shape[1]
        slot = q_offset % t
        ck[:, slot:slot + 1].copy_(k)
        cv[:, slot:slot + 1].copy_(v)
        ctx = flash_attention(q.to(ck.dtype), ck, cv, q_offset=min(q_offset, t - 1))
        k, v = ck, cv
    else:
        ctx = flash_attention(q, k, v, q_offset=0, window=window)
    out = ctx.reshape(b, s, h * hd).to(x.dtype) @ params["wo"].reshape(h * hd, -1)
    return out, (k, v)


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


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    """The SwiGLU MLP over [B, S, d], in row chunks of FFN_CHUNK_VALUES."""
    x2d = x.reshape(-1, x.shape[-1])
    rows = max(1, FFN_CHUNK_VALUES // params["w_gate"].shape[-1])
    if x2d.shape[0] <= rows:
        return swiglu(x2d, params["w_gate"], params["w_in"], params["w_out"]).view(x.shape)
    out = torch.empty_like(x2d)
    for i in range(0, x2d.shape[0], rows):
        out[i:i + rows] = swiglu(x2d[i:i + rows], params["w_gate"], params["w_in"],
                                 params["w_out"])
    return out.view(x.shape)

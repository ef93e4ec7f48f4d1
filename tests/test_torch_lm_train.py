"""LM training in the port against the JAX package, on the CPU: the plain
FlashAttention backward against JAX's custom VJP (``_attend_flash_bwd``)
and its dense path, ``flash_attention``'s autograd, the five archs' loss
gradients (reduced as ``tests/test_arch_smoke.py`` reduces them, with
JAX's flash attention and remat on its path), the in-place AdamW update,
the train_4k cell and the train launcher's LM branch with a resume.
Inputs are seeded numpy draws; JAX's parameters are carried across
(``convert.params_from_arrays``).

Tolerances: attention gradients within 2e-5 of each tensor's largest
|value| (fp32; JAX keeps (m, l) a row, the port one lse: the rounding
differs).  Each block's VJP on JAX's own block input and loss cotangent
within the same 2e-5 of a leaf's largest, every block of the five archs
(gemma's included).  An arch's loss within 1e-6 relative (gemma 1e-5).
Its whole-model gradient leaves within ARCH_GRAD_RTOL of their largest
|value|: there each package runs its own forward, and the two fp32
forwards differ by up to 1e-5 of a logit (3.4e-4 for gemma, whose tied
N(0, 1) embedding makes JAX's own fp32 logits 3e-3 from float64;
tests/test_torch_lm.py); a block's gradient on the two inputs then
differs by what its VJP amplifies that drift by, measured up to 8.7e-5 of
the largest (qwen3's embedding) and 2.3e-3 for gemma, while on one input
the blocks agree within 2e-5.  The same gradients through the port's flash
attention and through autograd of its dense plain attention agree within
2e-5 of each leaf's largest (measured 6e-6), as JAX's flash and dense
paths agree with each other (4e-6; 2.8e-4 for gemma).  The bf16 head
product's VJP (``matmul_f32_vjp``) within one bf16 rounding of JAX's.
The launcher's losses within 1e-4 relative, as the recsys loop's
(tests/test_torch_train.py)."""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as jax_train_launcher
from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attn import (
    flash_attention,
    flash_attention_bwd_ref,
    flash_attention_fwd_ref,
    flash_attention_fwd_residual_ref,
    flash_attention_ref,
)
from repro_torch.launch import train as train_launcher
from repro_torch.models import layers as TL
from repro_torch.models import transformer as ttf
from repro_torch.train import adamw_init, adamw_update, adamw_update_, value_and_grad
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import leaves, named_leaves, tree_map, unflatten
from test_arch_smoke import LM_ARCHS, _reduced_lm
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture
from test_torch_lm import _t, port_cfg

ATTN_RTOL = 2e-5
LOSS_RTOL = {"gemma3-12b": 1e-5}
LOSS_RTOL_DEFAULT = 1e-6
ARCH_GRAD_RTOL = {"gemma3-12b": 5e-3}
ARCH_GRAD_RTOL_DEFAULT = 2e-4
LAUNCHER_RTOL = 1e-4

J_VALUE_AND_GRAD = jax.jit(jax.value_and_grad(jtf.lm_loss), static_argnums=(2,))


def _within(got, want, rtol, what):
    """max |got - want| <= rtol * max |want|."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got.astype(np.float32) - want).max())
    assert err <= rtol * scale, f"{what}: {err / max(scale, 1e-30):.3g} of the largest"


# -------------------------------------------------------------- attention


def _attn_inputs(b, s, kvh, g, hd, seed):
    rng = np.random.default_rng(seed)
    draw = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return draw(b, s, kvh * g, hd), draw(b, s, kvh, hd), draw(b, s, kvh, hd), \
        draw(b, s, kvh * g, hd)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 8])
def test_flash_bwd_ref_matches_jax(window, g, hd):
    """dq, dk, dv of the plain backward against jax.vjp of JAX's
    ``_attend_flash`` (its custom backward) at S = 32 with kv_chunk 8, and
    against its dense path ``_attend_block`` at a ragged S of 27."""
    b, kvh = 2, 2
    for s, kv_chunk in ((32, 8), (27, None)):
        q, k, v, dout = _attn_inputs(b, s, kvh, g, hd, seed=s + g + hd)
        pos = jnp.arange(s, dtype=jnp.int32)
        qg = jnp.asarray(q).reshape(b, s, kvh, g, hd)
        if kv_chunk:
            fn = lambda qg, k, v: JL._attend_flash(qg, k, v, pos, pos, window, kv_chunk)  # noqa
        else:
            fn = lambda qg, k, v: JL._attend_block(qg, k, v, pos, pos, window)  # noqa: E731
        _, vjp = jax.vjp(fn, qg, jnp.asarray(k), jnp.asarray(v))
        jdq, jdk, jdv = vjp(jnp.asarray(dout).reshape(b, s, kvh, g, hd))
        tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, dout))
        out, lse = flash_attention_fwd_ref(tq, tk, tv, window=window)
        assert lse.shape == (b, kvh * g, s) and lse.dtype == torch.float32
        dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, out, tdo, lse, window=window,
                                             kv_chunk=8)
        what = f"S {s} window {window} G {g} hd {hd}"
        _within(dq, np.asarray(jdq).reshape(b, s, kvh * g, hd), ATTN_RTOL, f"dq {what}")
        _within(dk, jdk, ATTN_RTOL, f"dk {what}")
        _within(dv, jdv, ATTN_RTOL, f"dv {what}")


@pytest.mark.parametrize("shape", [(2, 20, 20, 4, 2, 16, 0, None), (1, 24, 24, 4, 1, 32, 0, 5),
                                   (2, 9, 30, 2, 2, 16, 21, None), (1, 6, 12, 2, 1, 16, 0, 4)])
def test_flash_attention_grad_on_cpu_equals_autograd_of_ref(shape):
    """A gradient-needing call on the CPU goes through ``_FlashAttention``
    (the plain forward with lse, the plain backward): its output equals
    ``flash_attention_ref``'s and its gradients autograd's of it.  The last
    shape has rows with no key in their window (gradients 0 there)."""
    b, s, t, h, kvh, hd, off, win = shape
    rng = np.random.default_rng(sum(shape[:6]))
    q, k, v = (torch.tensor(rng.normal(size=sh).astype(np.float32), requires_grad=True)
               for sh in ((b, s, h, hd), (b, t, kvh, hd), (b, t, kvh, hd)))
    dout = torch.from_numpy(rng.normal(size=(b, s, h, hd)).astype(np.float32))
    out = flash_attention(q, k, v, q_offset=off, window=win)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    got = torch.autograd.grad(out, (q, k, v), dout)
    ref = flash_attention_ref(q, k, v, q_offset=off, window=win)
    want = torch.autograd.grad(ref, (q, k, v), dout)
    assert torch.equal(out.detach(), ref.detach())
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _within(a, w.numpy(), ATTN_RTOL, f"{name} {shape}")
    assert bool(torch.isfinite(torch.cat([x.flatten() for x in got])).all())


# bf16: the card's backward is held to the plain version per tensor by
# |got - want| <= 2**-7 |want| + 2**-8 max |want| (chip_smoke.py's
# FLASH_BWD_TOL["bfloat16"]): 2**-7 for the two outputs' roundings to bf16
# (2**-8 of a value each), 2**-8 of the largest for a ds at a rounding
# boundary that rounds the other way in one of the two, moving one term of a
# sum by an ulp of that term.  The same limit holds the plain version to JAX.
BF16_BWD_RTOL, BF16_BWD_ATOL = 2**-7, 2**-8


def _within_bf16(got, want, what, atol=BF16_BWD_ATOL):
    got, want = (x.detach().float() if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.array(x, np.float32)) for x in (got, want))
    assert bool(torch.isfinite(got).all()), f"{what}: not finite"
    top = float(want.abs().max())
    bad = (got - want).abs() > BF16_BWD_RTOL * want.abs() + atol * top
    assert not bool(bad.any()), (f"{what}: {int(bad.sum())} values outside the bf16 limit, "
                                 f"max err {float((got - want).abs().max()):.3g} of {top:.3g}")


def _bf16(x):
    """A seeded fp32 draw as bf16 (torch), and its exact fp32 values (numpy)."""
    t = torch.from_numpy(x).to(torch.bfloat16)
    return t, t.float().numpy()


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 8])
def test_flash_bwd_ref_bf16_matches_jax(window, g, hd):
    """The plain backward on bf16 inputs against jax.vjp of JAX's
    ``_attend_flash`` on the same bf16 values and cotangent, kv_chunk 8: the
    bf16 semantics (fp32 scores and sums, ds rounded to bf16, dv from fp32
    p, outputs rounded once) that the card's kernel is held to.  Given
    JAX's residuals, the fp32 output of ``_flash_fwd_scan`` and lse = m +
    log l, it is within the bf16 limit.  Given the output rounded to bf16
    instead (what the card's backward read for delta before it took the
    forward's fp32 residual), that rounding (half a bf16 ulp of each output
    element) moves delta, and so ds before its rounding, which then rounds
    the other way in many places: the limit's atol is 2**-7 of the largest
    there, twice the kernel-against-plain one."""
    b, s, kvh = 2, 32, 2
    arrays = _attn_inputs(b, s, kvh, g, hd, seed=100 + s + g + hd)
    (tq, q), (tk, k), (tv, v), (tdo, dout) = map(_bf16, arrays)
    pos = jnp.arange(s, dtype=jnp.int32)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    qg = jq.reshape(b, s, kvh, g, hd)
    fn = lambda qg, k, v: JL._attend_flash(qg, k, v, pos, pos, window, 8)  # noqa: E731
    _, vjp = jax.vjp(fn, qg, jk, jv)
    jdq, jdk, jdv = vjp(jnp.asarray(dout).astype(jnp.bfloat16).reshape(b, s, kvh, g, hd))
    assert jdq.dtype == jnp.bfloat16
    want = (np.asarray(jdq.astype(jnp.float32)).reshape(b, s, kvh * g, hd),
            np.asarray(jdk.astype(jnp.float32)), np.asarray(jdv.astype(jnp.float32)))
    jout, jm, jl = JL._flash_fwd_scan(qg, jk, jv, pos, pos, window, 8)   # [B, KV, G, S, ...]
    out = torch.from_numpy(np.array(jout)).permute(0, 3, 1, 2, 4).reshape(b, s, kvh * g, hd)
    lse = torch.from_numpy(np.array(jm + jnp.log(jl))).reshape(b, kvh * g, s)
    for o, atol in ((out, BF16_BWD_ATOL), (out.to(torch.bfloat16), 2**-7)):
        got = flash_attention_bwd_ref(tq, tk, tv, o, tdo, lse, window=window, kv_chunk=8)
        assert got[0].dtype == torch.bfloat16
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            _within_bf16(a, w, f"{name} window {window} G {g} hd {hd} out {o.dtype}", atol)


@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 8])
def test_flash_attention_bf16_grad_on_cpu_matches_jax_at_one_chunk(window, g, hd):
    """The port's bf16 training path on the CPU (``flash_attention`` with a
    gradient: ``_FlashAttention``, whose forward keeps the fp32 residual of
    ``flash_attention_fwd_residual_ref`` and whose backward reads it for
    delta) against jax.vjp of JAX's ``_attend_flash`` at one kv chunk
    (kv_chunk = S: the port has no kv_chunk, one call takes every key), on
    the inputs of ``test_flash_bwd_ref_bf16_matches_jax``, within the bf16
    limit (2**-7 relative, 2**-8 of the largest).  JAX's own bf16 gradient
    moves with its kv chunk by about that much: at kv_chunk 8 and 32 it
    differs in one element by 1.01 of this limit (G 1, hd 64, causal), so
    the comparison is at one chunk.  The forward's output is the residual
    rounded to bf16."""
    b, s, kvh = 2, 32, 2
    arrays = _attn_inputs(b, s, kvh, g, hd, seed=100 + s + g + hd)
    (tq, q), (tk, k), (tv, v), (tdo, dout) = map(_bf16, arrays)
    pos = jnp.arange(s, dtype=jnp.int32)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    qg = jq.reshape(b, s, kvh, g, hd)
    fn = lambda qg, k, v: JL._attend_flash(qg, k, v, pos, pos, window, s)  # noqa: E731
    _, vjp = jax.vjp(fn, qg, jk, jv)
    jdq, jdk, jdv = vjp(jnp.asarray(dout).astype(jnp.bfloat16).reshape(b, s, kvh, g, hd))
    want = (np.asarray(jdq.astype(jnp.float32)).reshape(b, s, kvh * g, hd),
            np.asarray(jdk.astype(jnp.float32)), np.asarray(jdv.astype(jnp.float32)))
    xs = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = flash_attention(*xs, window=window)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward" and out.dtype == torch.bfloat16
    _, _, res = flash_attention_fwd_residual_ref(tq, tk, tv, window=window)
    assert torch.equal(out.detach(), res.to(torch.bfloat16))
    got = torch.autograd.grad(out, xs, tdo)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        _within_bf16(a, w, f"{name} window {window} G {g} hd {hd}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_inputs_take_the_fp32_residual(dtype):
    """``check_bwd_inputs`` (what the backward kernels are given): out is the
    forward's fp32 residual for both input types; dout of q's type, lse
    fp32 [B, H, S].  Anything else raises before a launch."""
    from repro_torch.kernels.flash_attn.ops import check_bwd_inputs

    b, s, h, kvh, hd = 1, 8, 4, 2, 64
    q, dout = torch.zeros((b, s, h, hd), dtype=dtype), torch.zeros((b, s, h, hd), dtype=dtype)
    k = v = torch.zeros((b, s, kvh, hd), dtype=dtype)
    lse = torch.zeros((b, h, s))
    check_bwd_inputs(q, k, v, torch.zeros((b, s, h, hd)), dout, lse)
    if dtype == torch.bfloat16:
        with pytest.raises(TypeError, match="out has dtype"):
            check_bwd_inputs(q, k, v, torch.zeros_like(q), dout, lse)
    with pytest.raises(TypeError, match="dout has dtype"):
        check_bwd_inputs(q, k, v, torch.zeros((b, s, h, hd)), dout.double(), lse)
    with pytest.raises(ValueError, match="lse has shape"):
        check_bwd_inputs(q, k, v, torch.zeros((b, s, h, hd)), dout, lse[:, :, :4])


def _tensor_core_bwd_model(q, k, v, out, dout, lse, q_offset, window):
    """The arithmetic of csrc/flash_attn_bwd.cu's bf16 kernels (tc::dkv_kernel,
    tc::dq_kernel), in torch: s and dp as fp32 sums of exact bf16 products,
    p = exp2(s scale log2(e) - lse log2(e)) with the kernel's fp32 constants
    (0 where masked), ds = p (dp - delta) rounded to bf16, and the products'
    bf16 A operands: dv from p rounded to bf16 (the one rounding the plain
    version does not have), dk and dq from ds; fp32 sums, each output rounded
    to bf16 once after its scale."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    scale = f32(1.0 / hd ** 0.5)
    scale_log2 = scale * f32(1.4426950408889634)
    qf, dof, of = (x.float().transpose(1, 2) for x in (q, dout, out))      # [B, H, S, hd]
    kf, vf = (x.float().repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    delta = (dof * of).sum(-1)                                            # [B, H, S]
    sc = qf @ kf.transpose(-1, -2)                                        # [B, H, S, T]
    dp = dof @ vf.transpose(-1, -2)
    qi = q_offset + torch.arange(s)[:, None]
    ti = torch.arange(t)[None, :]
    ok = (ti <= qi) & ((ti > qi - window) if window else True)
    p = torch.exp2(sc * scale_log2 - (lse * f32(1.4426950408889634))[..., None])
    p = torch.where(ok, p, 0.0)
    ds = (p * (dp - delta[..., None])).to(torch.bfloat16).float()
    pb = p.to(torch.bfloat16).float()
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale                              # [B, H, T, hd]
    dv = pb.transpose(-1, -2) @ dof
    group = lambda x: x.view(b, kvh, g, t, hd).sum(2).transpose(1, 2)     # noqa: E731
    return (dq.transpose(1, 2).to(torch.bfloat16), group(dk).to(torch.bfloat16),
            group(dv).to(torch.bfloat16))


@pytest.mark.parametrize("shape", [(1, 96, 96, 4, 1, 64, 0, None), (2, 80, 80, 2, 2, 256, 0, 17),
                                   (1, 64, 100, 2, 1, 64, 110, 20), (2, 128, 128, 8, 2, 64, 0, 9),
                                   (1, 72, 72, 4, 4, 256, 0, None)])
def test_tensor_core_bwd_rounding_fits_the_bf16_limit(shape):
    """The bf16 kernel's arithmetic (``_tensor_core_bwd_model``: p rounded to
    bf16 before dv, ds rounded as the plain version rounds it) against
    ``flash_attention_bwd_ref`` on the same bf16 inputs and the forward's
    fp32 residual, within the bf16 limit: windows, G 1 and 4, hd 64 and 256,
    and rows with no key (the third shape: their dq is 0)."""
    b, s, t, h, kvh, hd, off, win = shape
    rng = np.random.default_rng(sum(shape[:6]))
    draw = lambda *sh: torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(  # noqa
        torch.bfloat16)
    q, k, v, dout = draw(b, s, h, hd), draw(b, t, kvh, hd), draw(b, t, kvh, hd), draw(b, s, h, hd)
    # what the card's bf16 forward gives the backward: its fp32 residual
    _, lse, out = flash_attention_fwd_residual_ref(q, k, v, q_offset=off, window=win)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, q_offset=off, window=win)
    got = _tensor_core_bwd_model(q, k, v, out, dout, lse, off, win)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _within_bf16(a, w, f"{name} {shape}")
    empty = ~torch.isfinite(lse)                                          # [B, H, S]
    pos = off + torch.arange(s)
    no_key = pos - win + 1 >= t if win else torch.zeros(s, dtype=torch.bool)
    assert torch.equal(empty, no_key.expand_as(empty)), shape
    assert bool((got[0].transpose(1, 2)[empty] == 0).all())


# fp32: the card's backward runs its five products on the tensor cores in
# 3xTF32 (csrc/flash_attn_bwd.cu: namespace x3 by wgmma at hd 32 and 64, x3m
# by mma.sync at hd 128 and 256).  Their arithmetic, emulated
# here, is held to the plain version within FLASH_BWD_TOL["float32"] of
# chip_smoke.py: |got - want| <= 1e-4 max |want| a tensor.
F32_BWD_ATOL = 1e-4
BWD_SHAPES = [(1, 96, 96, 4, 1, 64, 0, None), (2, 80, 80, 2, 2, 256, 0, 17),
              (1, 64, 100, 2, 1, 64, 110, 20), (2, 128, 128, 8, 2, 64, 0, 9),
              (1, 72, 72, 4, 4, 256, 0, None)]


def _tf32(x):
    """x rounded to tf32 (10 mantissa bits) to nearest, ties away from zero,
    as cvt.rna.tf32.f32 does: half of the 13 dropped bits' weight is added
    to the magnitude's bits, which are then cut."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The 3xTF32 split: big = tf32(x), small = tf32(x - big)."""
    big = _tf32(x)
    return big, _tf32(x - big)


def _mm_tf32(a, b, passes):
    """a @ b as the tensor cores form it from tf32 operands, fp32 sums: one
    pass tf32(a) tf32(b); three passes small . big + big . small + big . big."""
    (ab, as_), (bb, bs) = _split(a), _split(b)
    if passes == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def _tf32_bwd_model(q, k, v, out, dout, lse, q_offset, window, passes=3):
    """The arithmetic of csrc/flash_attn_bwd.cu's fp32 kernels (x3 and
    x3m's dkv_kernel and dq_kernel) in torch: s, dp, and the dq, dk and dv
    products each from tf32 operands (``passes`` 3: split, three products;
    1: one rounding), fp32 sums, p = exp2(s scale log2(e) - lse log2(e))
    with the kernel's fp32 constants (0 where masked), ds = p (dp - delta),
    delta from the fp32 output."""
    b, s, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    scale = f32(1.0 / hd ** 0.5)
    scale_log2 = scale * f32(1.4426950408889634)
    qf, dof, of = (x.transpose(1, 2) for x in (q, dout, out))               # [B, H, S, hd]
    kf, vf = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    mm = functools.partial(_mm_tf32, passes=passes)
    delta = (dof * of).sum(-1)
    sc, dp = mm(qf, kf.transpose(-1, -2)), mm(dof, vf.transpose(-1, -2))  # [B, H, S, T]
    qi = q_offset + torch.arange(s)[:, None]
    ti = torch.arange(t)[None, :]
    ok = (ti <= qi) & ((ti > qi - window) if window else True)
    p = torch.where(ok, torch.exp2(sc * scale_log2 - (lse * f32(1.4426950408889634))[..., None]),
                    0.0)
    ds = p * (dp - delta[..., None])
    dq = mm(ds, kf) * scale
    dk = mm(ds.transpose(-1, -2), qf) * scale                               # [B, H, T, hd]
    dv = mm(p.transpose(-1, -2), dof)
    group = lambda x: x.view(b, kvh, g, t, hd).sum(2).transpose(1, 2)       # noqa: E731
    return dq.transpose(1, 2), group(dk), group(dv)


def _f32_bwd_case(shape, passes):
    """(the model's (dq, dk, dv), the plain version's, lse) on seeded fp32
    inputs of ``shape``, the forward's fp32 output and lse."""
    b, s, t, h, kvh, hd, off, win = shape
    rng = np.random.default_rng(sum(shape[:6]))
    draw = lambda *sh: torch.from_numpy(rng.normal(size=sh).astype(np.float32))  # noqa: E731
    q, k, v, dout = draw(b, s, h, hd), draw(b, t, kvh, hd), draw(b, t, kvh, hd), draw(b, s, h, hd)
    out, lse = flash_attention_fwd_ref(q, k, v, q_offset=off, window=win)
    want = flash_attention_bwd_ref(q, k, v, out, dout, lse, q_offset=off, window=win)
    got = _tf32_bwd_model(q, k, v, out, dout, lse, off, win, passes)
    return got, want, lse


def _err_of_largest(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_3xtf32_bwd_fits_the_fp32_limit(shape):
    """The fp32 kernel's arithmetic (``_tf32_bwd_model``, three passes)
    against ``flash_attention_bwd_ref`` on the same fp32 inputs, within
    FLASH_BWD_TOL["float32"] (1e-4 of each tensor's largest): the shapes of
    the bf16 test (windows, G 1 and 4, hd 64 and 256, rows with no key,
    whose dq is 0)."""
    b, s, t, h, kvh, hd, off, win = shape
    got, want, lse = _f32_bwd_case(shape, passes=3)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert bool(torch.isfinite(a).all()), f"{name} {shape}: not finite"
        err = _err_of_largest(a, w)
        assert err <= F32_BWD_ATOL, f"{name} {shape}: {err:.3g} of the largest"
    empty = ~torch.isfinite(lse)                                          # [B, H, S]
    pos = off + torch.arange(s)
    no_key = pos - win + 1 >= t if win else torch.zeros(s, dtype=torch.bool)
    assert torch.equal(empty, no_key.expand_as(empty)), shape
    assert bool((got[0].transpose(1, 2)[empty] == 0).all())


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_one_tf32_pass_misses_the_fp32_limit(shape):
    """One tf32 pass a product (each operand rounded once to 10 mantissa
    bits) is not fp32's accuracy: at every shape some gradient tensor is
    further than FLASH_BWD_TOL["float32"] from the plain version (4e-4 to
    1e-3 of its largest).  So the kernel splits every operand."""
    got, want, _ = _f32_bwd_case(shape, passes=1)
    worst = max(_err_of_largest(a, w) for a, w in zip(got, want))
    assert worst > F32_BWD_ATOL, f"{shape}: one pass is {worst:.3g} of the largest"


def test_tf32_split():
    """The split: big and small are tf32 values (low 13 bits 0); for a
    normal x (one whose small part is normal too: |x| >= 2**-100 here), big +
    small is within 2**-21 |x| of x (pi: 7.6e-8 relative);
    +-0 splits into +-0 and +0; a tie goes away from zero (rna, not rne);
    a subnormal keeps what 10 bits hold at its scale, so its error is
    stated in absolute terms: within 2**-137, half a tf32 step there."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096))
                         .astype(np.float32))
    x = torch.cat([x, torch.tensor([np.pi, -np.pi, 1.0, 3.4e38, 1e-30], dtype=torch.float32)])
    big, small = _split(x)
    for part in (big, small):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    err = (big.double() + small.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
    pi = torch.tensor([np.pi], dtype=torch.float32)
    assert float(err[-5]) / float(pi) < 1e-7
    for z in (0.0, -0.0):
        b0, s0 = _split(torch.tensor([z], dtype=torch.float32))
        assert float(b0) == 0.0 and float(s0) == 0.0
        assert np.signbit(float(b0)) == np.signbit(z) and not np.signbit(float(s0))
    tie = torch.tensor([0x3F801000, 0x3F803000, -0x407FF000], dtype=torch.int32).view(
        torch.float32)  # 1 + 2**-11, 1 + 3 * 2**-11, -(1 + 2**-11): halfway between tf32s
    assert _tf32(tie).view(torch.int32).tolist() == [0x3F802000, 0x3F804000, -0x407FE000]
    sub = torch.tensor([1e-40, -3e-42, 5e-39], dtype=torch.float32)
    b1, s1 = _split(sub)
    assert bool(((b1.double() + s1.double() - sub.double()).abs() <= 2.0 ** -137).all())
    assert abs(float(b1[0] + s1[0]) / 1e-40 - 1) > 0.01  # 1e-40: 3.3% off


# ------------------------------------------------------------------ archs


@functools.lru_cache(maxsize=None)
def _lm_setup(arch_id):
    """(JAX's config, the port's, JAX's params, the port's copy); shared by
    the tests, which do not modify them."""
    jcfg = dataclasses.replace(_reduced_lm(arch_id), flash=True, kv_chunk=8, remat=True)
    jp, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, port_cfg(jcfg), jp, _t(jp)


def _lm_batch(vocab, seed, b=2, s=16):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)
    return toks, np.roll(toks, -1, 1)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_loss_gradients_match_jax(arch_id, monkeypatch):
    """value_and_grad(lm_loss) against jax.value_and_grad(lm_loss), JAX
    with flash attention (kv_chunk 8, its custom VJP) and remat on: the loss
    and every gradient leaf, JAX's cross-entropy by loss_chunk 8, the
    port's whole and by loss_chunk 8; in the port, remat on and off give the same bits, and
    the gradients through the flash attention's backward equal autograd's
    through the dense plain attention."""
    jcfg, tcfg, jp, tp = _lm_setup(arch_id)
    assert tcfg.remat
    rtol = ARCH_GRAD_RTOL.get(arch_id, ARCH_GRAD_RTOL_DEFAULT)
    toks, labels = _lm_batch(jcfg.vocab, seed=11)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    grad_fn = value_and_grad(ttf.lm_loss)
    jloss, jgrads = J_VALUE_AND_GRAD(jp, jb, dataclasses.replace(jcfg, loss_chunk=8))
    want = {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    for chunk in (0, 8):  # the port's whole and chunked cross-entropy, JAX's chunked
        loss, grads = grad_fn(tp, tb, dataclasses.replace(tcfg, loss_chunk=chunk))
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LOSS_RTOL.get(arch_id, LOSS_RTOL_DEFAULT))
        got = dict(named_leaves(grads))
        assert list(got) == list(want)
        for name, g in got.items():
            _within(g, want[name], rtol, f"{arch_id} loss_chunk {chunk} grad {name}")
    _, no_remat = grad_fn(tp, tb, dataclasses.replace(tcfg, remat=False, loss_chunk=8))
    for (name, a), (_, b) in zip(named_leaves(grads), named_leaves(no_remat)):
        assert torch.equal(a, b), f"{arch_id}: remat changed the gradient of {name}"
    monkeypatch.setattr(TL, "flash_attention", flash_attention_ref)
    _, dense = grad_fn(tp, tb, dataclasses.replace(tcfg, loss_chunk=8))
    for (name, a), (_, b) in zip(named_leaves(grads), named_leaves(dense)):
        _within(a, b.numpy(), ATTN_RTOL, f"{arch_id} flash vs dense attention, grad {name}")


def _jax_blocks(blocks, cfg):
    return [(jax.tree.map(lambda a, r=r, p=p: a[r, p], blocks), w)
            for r in range(cfg.n_rep) for p, w in enumerate(cfg.window_pattern)]


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_block(bp, x, cfg, window):
    pos = jnp.arange(x.shape[1], dtype=jnp.int32)
    return jtf._block_apply(bp, x, pos, cfg, window, None)[0]


@functools.partial(jax.jit, static_argnums=(3, 4))
def _jax_block_vjp(bp, x, dy, cfg, window):
    """jax.vjp of JAX's ``_block_apply`` at ``x`` for the cotangents (``dy``,
    0.01 for the aux loss, as lm_loss weighs it): (dx, the params')."""
    pos = jnp.arange(x.shape[1], dtype=jnp.int32)
    block = lambda x, bp: jtf._block_apply(bp, x, pos, cfg, window, None)[::2]  # noqa: E731
    return jax.vjp(block, x, bp)[1]((dy, jnp.float32(0.01)))


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_head_cotangent(x, jp, labels, cfg):
    """The loss's cotangent at the last block's output (JAX's final norm and
    cross-entropy)."""
    def nll(x):
        h = JL.rmsnorm(x, jp["final_ln"])
        unembed = jp["embed"].T if cfg.tied_embed else jp["unembed"]
        logits = jnp.einsum("bsd,dv->bsv", h, unembed, preferred_element_type=jnp.float32)
        gold = jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0]
        return jnp.mean(jax.nn.logsumexp(logits, axis=-1) - gold)
    return jax.grad(nll)(x)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_block_vjps_match_jax(arch_id):
    """Each block's VJP on JAX's own block input and loss cotangent: the
    port's (autograd through its flash attention's backward) against
    jax.vjp of JAX's ``_block_apply`` (flash, kv_chunk 8: its custom VJP),
    the input's gradient and every parameter's within 2e-5 of the tensor's
    largest |value|, a MoE block's aux loss weighed 0.01 as lm_loss weighs
    it.  On the same input the backward agrees as tightly as the attention
    alone; the whole-model gradients above differ more only because the two
    forwards drift apart."""
    jcfg, tcfg, jp, tp = _lm_setup(arch_id)
    toks, labels = _lm_batch(jcfg.vocab, seed=11)
    jblocks = _jax_blocks(jp["blocks"], jcfg)
    ins = [jnp.take(jp["embed"], jnp.asarray(toks), axis=0)]
    for bp, window in jblocks:
        ins.append(_jax_block(bp, ins[-1], jcfg, window))
    dy = _jax_head_cotangent(ins.pop(), jp, jnp.asarray(labels), jcfg)
    layers = list(ttf._layers(tp, tcfg))
    for i in reversed(range(len(jblocks))):  # a block's dx is the cotangent of the one before
        (jbp, window), x = jblocks[i], ins[i]
        jdx, jdbp = _jax_block_vjp(jbp, x, dy, jcfg, window)
        want = {jax.tree_util.keystr(p): np.asarray(g)
                for p, g in jax.tree_util.tree_flatten_with_path(jdbp)[0]}
        _, _, twindow, tbp = layers[i]
        assert twindow == window
        tx = torch.from_numpy(np.array(x)).requires_grad_(True)
        own = [p.detach().requires_grad_(True) for p in leaves(tbp)]
        y, _, aux = ttf._block_apply(unflatten(tbp, own), tx, torch.arange(toks.shape[1]),
                                     tcfg, window)
        outs, cots = [y], [torch.from_numpy(np.array(dy))]
        if aux is not None:
            outs.append(aux)
            cots.append(torch.full_like(aux, 0.01))
        grads = torch.autograd.grad(outs, [tx, *own], cots, allow_unused=True)
        _within(grads[0], jdx, ATTN_RTOL, f"{arch_id} block {i} dx")
        got = dict(named_leaves(unflatten(tbp, grads[1:])))
        assert list(got) == list(want)
        for name, g in got.items():
            _within(torch.zeros(()) if g is None else g, want[name], ATTN_RTOL,
                    f"{arch_id} block {i} grad {name}")
        dy = jdx


def test_matmul_f32_vjp_matches_jax(monkeypatch):
    """The bf16 head product's VJP (what ``_MatmulF32`` runs on the card)
    against jax.vjp of JAX's ``einsum(..., preferred_element_type=f32)``:
    the fp32 cotangent enters fp32 products unrounded, each gradient is
    rounded once to bf16.  In steps of 128 columns of ``b``, with ``b`` a
    transposed view (a tied embedding): within one bf16 rounding of JAX's
    (2**-8 of a value, plus 1e-6 of the largest for the sums' order)."""
    monkeypatch.setattr(TL, "VJP_COLS", 128)
    rng = np.random.default_rng(5)
    a = rng.normal(size=(48, 64)).astype(np.float32)
    b = rng.normal(size=(300, 64)).astype(np.float32).T
    g = rng.normal(size=(48, 300)).astype(np.float32)
    _, vjp = jax.vjp(lambda x, w: jnp.einsum("sd,dv->sv", x, w,
                                             preferred_element_type=jnp.float32),
                     jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    ta = torch.from_numpy(a).bfloat16()
    tb = torch.from_numpy(np.ascontiguousarray(b.T)).bfloat16().T
    got = TL.matmul_f32_vjp(ta, tb, torch.from_numpy(g))
    assert got[1].shape == tb.shape and got[1].stride() == tb.stride()
    for name, t, w in zip(("dx", "db"), got, vjp(jnp.asarray(g))):
        assert t.dtype == torch.bfloat16
        t, w = t.float().numpy(), np.asarray(w, np.float32)
        assert (np.abs(t - w) <= 2**-8 * np.abs(w) + 1e-6 * np.abs(w).max()).all(), name


def test_adamw_update_in_place_is_adamw_update_bit_for_bit(monkeypatch):
    """adamw_update_ on the reduced qwen3 tree (stacked blocks, experts, the
    fp32 router) in slices of 1,000 elements: params and moments equal
    adamw_update's bit for bit over two steps, written into the same
    tensors."""
    monkeypatch.setattr(topt, "UPDATE_SLICE", 1000)
    tcfg = dataclasses.replace(_lm_setup("qwen3-moe-235b-a22b")[1], dtype=torch.bfloat16)
    params = ttf.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    grads = tree_map(lambda p: torch.randn(p.shape, generator=g).to(p.dtype), params)
    want_p, want_o = params, adamw_init(params)
    own_p = tree_map(torch.clone, params)
    own_o = adamw_init(own_p)
    before = [id(x) for _, x in named_leaves((own_p, own_o.mu, own_o.nu))]
    for lr in (1e-3, 2e-3):
        want_p, want_o = adamw_update(grads, want_o, want_p, lr=torch.tensor(lr))
        own_p, own_o = adamw_update_(grads, own_o, own_p, lr=torch.tensor(lr))
    assert [id(x) for _, x in named_leaves((own_p, own_o.mu, own_o.nu))] == before
    assert int(own_o.step) == int(want_o.step) == 2
    for (name, a), (_, b) in zip(named_leaves((own_p, own_o)), named_leaves((want_p, want_o))):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("arch_id", ["granite-3-2b", "qwen3-moe-235b-a22b"])
def test_train_cell_steps_on_the_cpu_at_a_reduced_size(arch_id):
    """The train_4k cell's step at a reduced size, driven as chip_smoke.py
    drives the published one: the loss finite, params and moments written
    in place, and the step's values those of value_and_grad(lm_loss) then
    adamw_update at JAX's schedule (base 3e-4, warmup 2,000, total
    100,000) on copies."""
    tcfg = _lm_setup(arch_id)[1]
    arch = dataclasses.replace(get_arch(arch_id), cfg=tcfg)
    cell = arch.build_cell("train_4k", device="cpu")
    assert cell.meta["kind"] == "train" and cell.meta["tokens"] == 256 * 4096
    params = arch.init(torch.Generator().manual_seed(0), device="cpu")
    opt = adamw_init(params)
    copy_p = tree_map(torch.clone, params)
    toks, labels = _lm_batch(tcfg.vocab, seed=3)
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    loss0, grads = value_and_grad(ttf.lm_loss)(copy_p, batch, tcfg)
    want_p, want_o = adamw_update(grads, adamw_init(copy_p), copy_p,
                                  lr=topt.cosine_schedule(torch.tensor(0, dtype=torch.int32),
                                                          base_lr=3e-4, warmup=2000,
                                                          total=100_000))
    new_p, new_o, loss = cell.step_fn(params, opt, batch)
    assert new_p is params and bool(torch.isfinite(loss)) and float(loss) == float(loss0)
    for (name, a), (_, b) in zip(named_leaves((new_p, new_o)), named_leaves((want_p, want_o))):
        assert torch.equal(a, b), name
    _, _, loss2 = cell.step_fn(new_p, new_o, batch)
    assert bool(torch.isfinite(loss2)) and int(new_o.step) == 1
    with pytest.raises(ValueError, match="runs on"):
        cell.step_fn(params, opt, {k: x.to("meta") for k, x in batch.items()})


# --------------------------------------------------------------- launcher


class _Preempted(Exception):
    pass


def test_lm_train_launcher_matches_jax_and_resumes(monkeypatch, tmp_path, capsys):
    """``repro_torch.launch.train --arch granite-3-2b --device cpu --steps 3
    --batch 2`` against the JAX launcher on JAX's initial weights (its
    ``_tiny_lm`` at PRNGKey(0), carried across): each step's loss within
    1e-4 relative.  Then a run checkpointing every 2 steps is cut at step 2
    (the stream raises) and the same command resumes from its checkpoint:
    the resumed step's loss equals the uninterrupted run's."""
    arch_id = "granite-3-2b"
    jcfg = jax_train_launcher._tiny_lm(jax_get_arch(arch_id).cfg)
    assert port_cfg(jcfg) == train_launcher._tiny_lm(get_arch(arch_id).cfg)
    jparams, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    runs = []
    run = jax_train_launcher.loop.run
    monkeypatch.setattr(jax_train_launcher.loop, "run",
                        lambda *a, **kw: runs.append(run(*a, **kw)) or runs[-1])
    monkeypatch.setattr(sys, "argv", ["train", "--arch", arch_id, "--steps", "3", "--batch", "2"])
    jax_train_launcher.main()
    want = [h["loss"] for h in runs[0].history]

    monkeypatch.setattr(train_launcher, "_lm_init", lambda cfg, device: _t(jparams))
    argv = ["--arch", arch_id, "--device", "cpu", "--steps", "3", "--batch", "2"]
    got = [h["loss"] for h in train_launcher.main(argv).history]
    np.testing.assert_allclose(got, want, rtol=LAUNCHER_RTOL)
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"[train] {arch_id}: loss ")

    stream_cls = train_launcher.SyntheticLMStream

    class CutAtStep2(stream_cls):
        def batch_at(self, step):
            if step == 2:
                raise _Preempted()
            return super().batch_at(step)

    ckpt_argv = argv + ["--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "2"]
    monkeypatch.setattr(train_launcher, "SyntheticLMStream", CutAtStep2)
    with pytest.raises(_Preempted):
        train_launcher.main(ckpt_argv)
    monkeypatch.setattr(train_launcher, "SyntheticLMStream", stream_cls)
    resumed = train_launcher.main(ckpt_argv)
    assert "resumed from step 2" in capsys.readouterr().out
    assert [h["loss"] for h in resumed.history] == got[2:]

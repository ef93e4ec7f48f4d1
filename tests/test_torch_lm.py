"""The port's LM family against the JAX package's, on the CPU: layers,
attention (prefill and ring-buffer decode), the five archs reduced as
``tests/test_arch_smoke.py`` reduces them, their published configs' counts
and parameter trees, bf16 carries and checkpoints, and the decode example.
Inputs are seeded numpy draws; JAX's parameters are carried across
(``convert.params_from_arrays``).

Tolerances (fp32 unless stated): the layers within 2e-5 of their largest
output (rope: 2e-6; its angles are products of exact fp32 values), the
archs' logits within LOGIT_RTOL of the row's largest |logit|, caches within
the same of their largest value."""
import dataclasses
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.common import LM_SHAPES as JAX_LM_SHAPES
from repro.models import layers as JL
from repro.models import transformer as jtf
from repro.train import checkpoint as jax_ckpt
from repro_torch.configs import get_arch
from repro_torch.configs.common import LM_SHAPES
from repro_torch.convert import params_from_arrays
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as ttf
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.tree import named_leaves, tree_map
from test_arch_smoke import LM_ARCHS, _reduced_lm
from test_torch_build import one_torch_thread  # noqa: F401 -- an autouse fixture

ROOT = Path(__file__).resolve().parents[1]
LAYER_RTOL = 2e-5
# gemma's tied embedding is drawn N(0, 1) (scale 1.0) and read back as the
# unembedding, which makes its logits ~10x the others' and its forward
# ill-conditioned: JAX's own fp32 logits are 3e-3 from a float64 run of the
# same weights (0.0030 of 35.3 at the reduced size), as far as the port's
LOGIT_RTOL = {"gemma3-12b": 5e-4}
LOGIT_RTOL_DEFAULT = 2e-5
# bf16: the plain attention rounds q.k / sqrt(hd) to bf16 before its
# softmax, where JAX keeps fp32 logits; at the reduced granite's scores (up
# to ~60: wq draws at H**-0.5, not d**-0.5) a bf16 ulp of a score is 0.25,
# which moves a softmax weight by a quarter of itself.  Logits within 2**-4
# of the row's largest (measured: 0.036), the prefill's argmax equal
BF16_LOGIT_RTOL = 2**-4

# JAX's references, jitted once a config (un-jitted, a serve_step's scan
# takes about a second)
J_FORWARD = jax.jit(jtf.forward, static_argnums=(2,))
J_LOSS = jax.jit(jtf.lm_loss, static_argnums=(2,))
J_PREFILL = jax.jit(jtf.serve_prefill, static_argnums=(2,), static_argnames=("max_len",))
J_STEP = jax.jit(jtf.serve_step, static_argnums=(4,))


def port_cfg(jcfg) -> ttf.TransformerConfig:
    """The port's config of a JAX ``TransformerConfig`` (its XLA layout knobs
    dropped, its dtype mapped)."""
    names = {f.name for f in dataclasses.fields(ttf.TransformerConfig)} - {"dtype"}
    dtype = torch.float32 if jcfg.dtype == jnp.float32 else torch.bfloat16
    return ttf.TransformerConfig(**{n: getattr(jcfg, n) for n in names}, dtype=dtype)


def _t(tree):
    return params_from_arrays(jax.tree.map(np.asarray, tree), device="cpu")


def _close(got, want, rtol, what):
    """max |got - want| <= rtol * max |want| (per last-axis row where 2-d+)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max(axis=-1, keepdims=True) if want.ndim > 1 else np.abs(want).max()
    err = np.abs(got.astype(np.float32) - want)
    worst = float((err / np.maximum(scale, 1e-30)).max())
    assert (err <= rtol * scale).all(), f"{what}: {worst:.3g} of the largest"


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    g = rng.normal(size=64).astype(np.float32)
    jx, jg = jnp.asarray(x, dtype), jnp.asarray(g, dtype)
    want = JL.rmsnorm(jx, jg)
    got = TL.rmsnorm(*_t((jx, jg)))
    assert got.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":  # fp32 inside, one rounding to bf16: an ulp at most
        _close(got, want.astype(jnp.float32), 2**-8, "rmsnorm bf16")
    else:
        _close(got, want, LAYER_RTOL, "rmsnorm")


@pytest.mark.parametrize("theta,hd", [(1e4, 64), (1e4, 128), (1e6, 256), (1e6, 16)])
def test_rope_matches_jax_to_position_32768(theta, hd):
    rng = np.random.default_rng(1)
    pos = np.concatenate([np.arange(8), rng.integers(0, 32769, 56), [32767, 32768]])
    pos = pos.astype(np.int32)
    x = rng.normal(size=(2, len(pos), 3, hd)).astype(np.float32)
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    _close(got, want, 2e-6, f"rope theta={theta} hd={hd}")


def test_mlp_matches_jax(monkeypatch):
    rng = np.random.default_rng(2)
    p, _ = JL.mlp_init(jax.random.PRNGKey(0), 48, 80, jnp.float32)
    x = rng.normal(size=(3, 7, 48)).astype(np.float32)
    want = JL.mlp(p, jnp.asarray(x))
    tp = _t(p)
    _close(TL.mlp(tp, torch.as_tensor(x)), want, LAYER_RTOL, "mlp")
    # a prefill's row chunks leave every row as it was
    monkeypatch.setattr(TL, "FFN_CHUNK_VALUES", 80 * 4)
    _close(TL.mlp(tp, torch.as_tensor(x)), want, LAYER_RTOL, "mlp in row chunks")


def _attn_params(d, h, kv, hd, seed):
    p, _ = JL.attention_init(jax.random.PRNGKey(seed), d, h, kv, hd, jnp.float32)
    return p


@pytest.mark.parametrize("window,s,h,kv", [(None, 32, 4, 2), (None, 20, 4, 2), (8, 32, 4, 2),
                                           (8, 20, 4, 1), (None, 24, 4, 4)])
def test_attention_prefill_matches_jax(window, s, h, kv):
    """S = 32 takes JAX's chunked flash scan (kv_chunk 16), S = 20 / 24 its
    dense block; the port is one flash_attention call either way."""
    rng = np.random.default_rng(3)
    p = _attn_params(64, h, kv, 16, 0)
    x = rng.normal(size=(2, s, 64)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)
    want, (wk, wv) = JL.attention(p, jnp.asarray(x), jnp.asarray(pos), n_kv=kv, window=window,
                                  chunk=8, kv_chunk=16)
    got, (gk, gv) = TL.attention(_t(p), torch.as_tensor(x), torch.as_tensor(pos), n_kv=kv,
                                 window=window)
    _close(got, want, LAYER_RTOL, "attention")
    _close(gk, wk, LAYER_RTOL, "k")
    _close(gv, wv, LAYER_RTOL, "v")


@pytest.mark.parametrize("window,t,q_offset", [(8, 8, 3), (8, 8, 7), (8, 8, 13), (None, 16, 5)])
def test_ring_decode_matches_jax(window, t, q_offset):
    """Decode on a cache filled with seeded values (a zero cache would make
    every softmax uniform and hide a wrong mask): below the wrap, at it
    (q_offset = T - 1), past it, and a global layer; the output and the
    cache written in place equal JAX's."""
    rng = np.random.default_rng(4)
    p = _attn_params(64, 4, 2, 16, 1)
    x = rng.normal(size=(2, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(2, t, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(2, t, 2, 16)).astype(np.float32)
    pos = np.full((1,), q_offset, np.int32)
    want, (wk, wv) = JL.attention(p, jnp.asarray(x), jnp.asarray(pos), n_kv=2, window=window,
                                  kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
                                  q_offset=jnp.int32(q_offset))
    tk, tv = torch.as_tensor(ck.copy()), torch.as_tensor(cv.copy())
    got, (gk, gv) = TL.attention(_t(p), torch.as_tensor(x), torch.as_tensor(pos), n_kv=2,
                                 window=window, kv_cache=(tk, tv), q_offset=q_offset)
    assert gk is tk and gv is tv  # written in place
    _close(got, want, LAYER_RTOL, "decode")
    _close(gk, wk, LAYER_RTOL, "cache k")
    _close(gv, wv, LAYER_RTOL, "cache v")
    slot = q_offset % t
    untouched = [i for i in range(t) if i != slot]
    np.testing.assert_array_equal(gk.numpy()[:, untouched], ck[:, untouched])


def test_flash_attention_refuses_a_gradient_on_the_card(monkeypatch):
    """A CUDA input that needs a gradient goes through ``_FlashAttention``
    (the forward with lse, the backward kernel) once the kernel's input
    checks pass; a head dim the kernels do not take raises before it, with
    or without a gradient (``on_cuda`` faked for CPU tensors)."""
    monkeypatch.setattr(_lib, "on_cuda", lambda x: True)
    calls = []
    monkeypatch.setattr(flash_ops._FlashAttention, "apply",
                        lambda *args: calls.append(args) or "routed")
    q = torch.zeros((1, 4, 2, 64), requires_grad=True)
    k = torch.zeros((1, 4, 2, 64))
    assert flash_attention(q, k, k, window=3) == "routed"
    assert len(calls) == 1 and calls[0][3:] == (0, 3)
    with pytest.raises(ValueError, match="head dim 48"):
        flash_attention(*(torch.zeros((1, 4, 2, 48), requires_grad=True),) * 3)
    with torch.no_grad(), pytest.raises(ValueError, match="head dim 48"):
        flash_attention(*(torch.zeros((1, 4, 2, 48)),) * 3)
    assert len(calls) == 1


# ------------------------------------------------------------------- archs


def _setup(arch_id, dtype=jnp.float32):
    jcfg = dataclasses.replace(_reduced_lm(arch_id), dtype=dtype)
    jp, _ = jtf.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, port_cfg(jcfg), jp, _t(jp)


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_lm_matches_jax(arch_id):
    """forward (logits and aux), lm_loss (whole and by loss_chunk),
    serve_prefill and three serve_steps, caches included."""
    jcfg, tcfg, jp, tp = _setup(arch_id)
    rtol = LOGIT_RTOL.get(arch_id, LOGIT_RTOL_DEFAULT)
    rng = np.random.default_rng(5)
    b, s, max_len = 2, 16, 32
    toks = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    labels = np.roll(toks, -1, 1)

    jl, jaux = J_FORWARD(jp, jnp.asarray(toks), jcfg)
    tl, taux = ttf.forward(tp, torch.as_tensor(toks), tcfg)
    _close(tl, jl, rtol, f"{arch_id} forward")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want = J_LOSS(jp, jb, dataclasses.replace(jcfg, loss_chunk=8))  # JAX's chunked loss
    for chunk in (0, 8):  # the port's whole and chunked cross-entropy
        got = ttf.lm_loss(tp, {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)},
                          dataclasses.replace(tcfg, loss_chunk=chunk))
        np.testing.assert_allclose(float(got), float(want), rtol=max(rtol, 1e-5))

    jlp, jc = J_PREFILL(jp, jnp.asarray(toks), jcfg, max_len=max_len)
    tlp, tc = ttf.serve_prefill(tp, torch.as_tensor(toks), tcfg, max_len=max_len)
    _close(tlp, jlp, rtol, f"{arch_id} prefill")
    nxt = np.asarray(jnp.argmax(jlp, -1))[:, None].astype(np.int32)
    for i in range(3):
        jld, jc = J_STEP(jp, jc, jnp.asarray(nxt), jnp.int32(s + i), jcfg)
        tld, tc2 = ttf.serve_step(tp, tc, torch.as_tensor(nxt), s + i, tcfg)
        assert all(a is b for pa, pb in zip(tc, tc2) for a, b in zip(pa, pb))  # in place
        _close(tld, jld, rtol, f"{arch_id} step {i}")
        for (jk, jv), (gk, gv) in zip(jc, tc):
            _close(gk.reshape(-1, gk.shape[-1]), np.asarray(jk).reshape(-1, gk.shape[-1]),
                   rtol * 10, f"{arch_id} cache k")
            _close(gv.reshape(-1, gv.shape[-1]), np.asarray(jv).reshape(-1, gv.shape[-1]),
                   rtol * 10, f"{arch_id} cache v")
        nxt = np.asarray(jnp.argmax(jld, -1))[:, None].astype(np.int32)


def test_gemma_long_ring_decode_matches_jax():
    """Nine steps past gemma's reduced window of 8 (each sliding cache
    wraps): every step's logits equal JAX's serve_step, and the argmax
    equals the full forward's, as tests/test_arch_smoke.py holds JAX."""
    jcfg, tcfg, jp, tp = _setup("gemma3-12b")
    rtol = LOGIT_RTOL["gemma3-12b"]
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (1, 16)).astype(np.int32)
    _, jc = J_PREFILL(jp, jnp.asarray(toks), jcfg, max_len=32)
    _, tc = ttf.serve_prefill(tp, torch.as_tensor(toks), tcfg, max_len=32)
    cur = toks
    for i in range(9):
        full = ttf.forward(tp, torch.as_tensor(cur), tcfg)[0][:, -1]
        nxt = full.argmax(-1)[:, None].to(torch.int32).numpy()
        jld, jc = J_STEP(jp, jc, jnp.asarray(nxt), jnp.int32(16 + i), jcfg)
        tld, tc = ttf.serve_step(tp, tc, torch.as_tensor(nxt), 16 + i, tcfg)
        _close(tld, jld, rtol, f"step {i}")
        cur = np.concatenate([cur, nxt], axis=1)
        full2 = ttf.forward(tp, torch.as_tensor(cur), tcfg)[0][:, -1]
        _close(tld, full2, rtol, f"step {i} against the forward")
        assert bool((tld.argmax(-1) == full2.argmax(-1)).all())


def test_bf16_arch_matches_jax():
    """granite reduced in bf16 (every LM config's dtype), JAX's bf16 tree
    carried bit for bit: logits within BF16_LOGIT_RTOL, the argmax equal.
    The plain attention rounds q.k to bf16 before its softmax, JAX's keeps
    fp32 logits, which the tolerance also covers."""
    jcfg, tcfg, jp, tp = _setup("granite-3-2b", jnp.bfloat16)
    assert tcfg.dtype == torch.bfloat16
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 16)).astype(np.int32)
    jlp, jc = J_PREFILL(jp, jnp.asarray(toks), jcfg, max_len=24)
    tlp, tc = ttf.serve_prefill(tp, torch.as_tensor(toks), tcfg, max_len=24)
    assert tlp.dtype == torch.float32 and tc[0][0].dtype == torch.bfloat16
    _close(tlp, jlp, BF16_LOGIT_RTOL, "bf16 prefill")
    nxt = np.asarray(jnp.argmax(jlp, -1))[:, None].astype(np.int32)
    np.testing.assert_array_equal(tlp.argmax(-1).numpy(), nxt[:, 0])
    jld, _ = J_STEP(jp, jc, jnp.asarray(nxt), jnp.int32(16), jcfg)
    tld, _ = ttf.serve_step(tp, tc, torch.as_tensor(nxt), 16, tcfg)
    _close(tld, jld, BF16_LOGIT_RTOL, "bf16 step")


# ---------------------------------------------------- configs, trees, cells


@pytest.mark.parametrize("arch_id", LM_ARCHS)
def test_published_config_and_tree_match_jax(arch_id):
    """The published config field for field, param_count and
    active_param_count, and the init tree's leaf names, shapes and dtypes
    (JAX's eval_shape against the port's meta tensors)."""
    jcfg, tcfg = jax_get_arch(arch_id).cfg, get_arch(arch_id).cfg
    assert tcfg == port_cfg(jcfg)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    want = [(jax.tree_util.keystr(p), tuple(a.shape), str(a.dtype))
            for p, a in jax.tree_util.tree_flatten_with_path(jtf.abstract_params(jcfg))[0]]
    got = [(n, tuple(a.shape), str(a.dtype).split(".")[-1])
           for n, a in named_leaves(ttf.abstract_params(tcfg))]
    assert got == want


def test_lm_cells():
    """Every LM cell JAX lists builds, train_4k included, its meta JAX's
    keys and values; a mesh raises."""
    assert LM_SHAPES == JAX_LM_SHAPES
    for aid in LM_ARCHS:
        arch, jarch = get_arch(aid), jax_get_arch(aid)
        assert arch.shape_names() == jarch.shape_names()
        for shape in arch.shape_names():
            cell = arch.build_cell(shape, device="cpu")
            sh = LM_SHAPES[shape]
            b, s = sh["batch"], sh["seq"]
            assert cell.meta == dict(
                family="lm", arch=aid, shape=shape, kind=sh["kind"],
                params=jarch.cfg.param_count(), active_params=jarch.cfg.active_param_count(),
                tokens=b * s if sh["kind"] != "decode" else b)
            if sh["kind"] == "decode":
                caches = cell.args[1]
                assert cell.args[3] == s - 1 and tuple(cell.args[2].shape) == (b, 1)
                for (ck, _), w in zip(caches, arch.cfg.window_pattern):
                    assert tuple(ck.shape) == (arch.cfg.n_rep, b, s if w is None else min(w, s),
                                               arch.cfg.n_kv, arch.cfg.head_dim)
            elif sh["kind"] == "train":
                params, opt, batch = cell.args
                assert sorted(batch) == ["labels", "tokens"]
                assert all(tuple(x.shape) == (b, s) and x.dtype == torch.int32
                           for x in batch.values())
                assert [n for n, _ in named_leaves(opt.mu)] == [n for n, _ in named_leaves(params)]
            else:
                assert tuple(cell.args[1].shape) == (b, s)
    # a mesh that is not a DeviceMesh raises before any work (no params read)
    tcfg = _setup("granite-3-2b")[1]
    with pytest.raises(TypeError, match="DeviceMesh"):
        ttf.forward({}, torch.zeros((1, 4), dtype=torch.int32), tcfg, mesh=object())


def test_cell_steps_run_on_the_cpu_at_a_reduced_size():
    """A reduced arch's prefill and decode cells, driven as chip_smoke.py
    drives the published ones: the decode step writes its caches in place."""
    arch = get_arch("gemma3-12b")
    arch = dataclasses.replace(arch, cfg=_setup("gemma3-12b")[1])
    params = arch.init(torch.Generator().manual_seed(0), device="cpu")
    pre = arch.build_cell("prefill_32k", device="cpu")
    toks = torch.randint(0, arch.cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    logits, caches = pre.step_fn(params, toks)
    assert logits.shape == (2, arch.cfg.vocab) and bool(torch.isfinite(logits).all())
    dec = arch.build_cell("decode_32k", device="cpu")
    lg, out = dec.step_fn(params, caches, logits.argmax(-1)[:, None].to(torch.int32), 15)
    assert out is caches and bool(torch.isfinite(lg).all())
    with pytest.raises(ValueError, match="runs on"):
        pre.step_fn(params, toks.to("meta"))


def test_init_scale_is_jax_fan_in():
    """_dense_init's fan_in is shape[-2]: wq [d, H, hd] draws at H**-0.5
    (a property of the reference), the router in fp32."""
    cfg = port_cfg(dataclasses.replace(_reduced_lm("qwen3-moe-235b-a22b"), d_model=256))
    p = ttf.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    blk = p["blocks"]
    np.testing.assert_allclose(float(blk["attn"]["wq"].std()), cfg.n_heads ** -0.5, rtol=0.05)
    np.testing.assert_allclose(float(blk["attn"]["wo"].std()), cfg.head_dim ** -0.5, rtol=0.05)
    assert blk["ffn"]["router"].dtype == torch.float32
    assert float(p["embed"].std()) == pytest.approx(1.0, rel=0.05)


# ----------------------------------------------------------- bf16 carries


def test_bf16_tree_carries_bit_for_bit():
    jp, _ = jtf.init(jax.random.PRNGKey(1), dataclasses.replace(_reduced_lm("grok-1-314b"),
                                                                 dtype=jnp.bfloat16))
    tp = _t(jp)
    want = dict((jax.tree_util.keystr(p), np.asarray(a))
                for p, a in jax.tree_util.tree_flatten_with_path(jp)[0])
    for name, leaf in named_leaves(tp):
        w = want[name]
        if w.dtype.name == "bfloat16":
            assert leaf.dtype == torch.bfloat16
            np.testing.assert_array_equal(leaf.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(leaf.numpy(), w)


def _npz(d):
    step = sorted(x for x in os.listdir(d) if x.startswith("step_"))[-1]
    with open(os.path.join(d, step, "MANIFEST.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, step, "shard_0.npz")) as z:
        return manifest, {k: z[k] for k in z.files}


def test_bf16_checkpoints_both_ways(tmp_path):
    """JAX's save of a bf16 tree restores into the port bit for bit; the
    port's save writes what JAX's does (stored dtype, MANIFEST dtype, bytes).
    JAX's own restore of such a file fails ("No cast function available"),
    a property of the reference."""
    jp, _ = jtf.init(jax.random.PRNGKey(2), dataclasses.replace(_reduced_lm("gemma3-12b"),
                                                                 dtype=jnp.bfloat16))
    tp = _t(jp)
    jax_ckpt.save(str(tmp_path / "jax"), 3, jp)
    restored, manifest = ckpt.restore(str(tmp_path / "jax"), tp)
    assert manifest["leaves"]["['embed']"]["dtype"] == "bfloat16"
    for (name, a), (_, b) in zip(named_leaves(tp), named_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a.view(torch.int16), b.view(torch.int16)), name
    ckpt.save(str(tmp_path / "port"), 3, tp)
    jm, jz = _npz(tmp_path / "jax")
    tm, tz = _npz(tmp_path / "port")
    assert tm["leaves"] == jm["leaves"]
    assert {k: (v.dtype.str, v.shape) for k, v in tz.items()} == \
        {k: (v.dtype.str, v.shape) for k, v in jz.items()}
    for k in jz:
        assert jz[k].tobytes() == tz[k].tobytes(), k
    again, _ = ckpt.restore(str(tmp_path / "port"), tree_map(lambda a: a.to("meta"), tp),
                            device="cpu")
    for (name, a), (_, b) in zip(named_leaves(tp), named_leaves(again)):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16)) if a.dtype == torch.bfloat16 \
            else torch.equal(a, b), name
    with pytest.raises(ValueError, match="No cast function available"):
        jax_ckpt.restore(str(tmp_path / "port"), jp)


# ----------------------------------------------------------------- example


def test_lm_decode_example_on_cpu(capsys):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import lm_decode_torch
    finally:
        sys.path.remove(str(ROOT / "examples"))
    out = lm_decode_torch.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("prefill 32 tokens (cache: sliding layers keep 16 slots")
    assert "argmax identical at every checked step" in lines[1]
    assert lines[2].startswith("sequences: ")
    assert out["tokens"].shape == (2, 48) and out["max_err"] < 1e-3

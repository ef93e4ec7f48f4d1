"""How far fp32 gradients of an LM at its published widths are from float64
gradients of the same weights and tokens, on the CPU (the port's plain
versions).

  PYTHONPATH=src python scripts/lm_grad_conditioning.py [--arch granite-3-2b] \
      [--skip-free-run]

For each arch, with the layers cut to one pattern cycle as ``chip_smoke.py``
phase 11 (c) cuts them, batch 1, 256 tokens and loss_chunk 128, it prints:
- the free run: lm_loss's fp32 value and every gradient leaf against a
  float64 run, each leaf's max |g32 - g64| over its max |g64|;
- each block's VJP on the float64 run's input and output cotangent (its
  input's gradient and its parameters'), fp32 against float64, the worst
  leaf of each block; and the head's (final norm, the chunked
  cross-entropy) on the float64 run's last hidden state.
The free run shows how far two correct fp32 gradients can drift apart
(JAX's init draws the queries at H**-0.5, so attention scores run to
hundreds and an error grows at every layer); the blocks and the head are
the noise of one correct fp32 VJP, which phase 11 (c) holds the card to
(LM_BLOCK_GRAD_RTOL, LM_HEAD_GRAD_RTOL).  In the float64 run the port's
fp32 islands are replaced by float64 ones (attention by a dense float64
softmax, RMSNorm, SiLU, the router and the fp32-output products), so it
is float64 throughout but for RoPE's angles and the MoE gate values.
Memory: the free run keeps the fp32 gradients beside the float64 weights
and gradients, 20 bytes a parameter (75 GB for qwen3's one layer); with
``--skip-free-run`` the blocks need 16 (60 GB).  grok's one layer (6.5 B
parameters) is beyond a 96 GiB host either way and is left out unless
named.

``captured_blocks``, ``block_vjp``, ``head_vjp`` and ``forced_route`` are
also what ``chip_smoke.py`` phase 11 (c) holds the card to the CPU with.
"""
import argparse
import contextlib
import dataclasses
import gc

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_arch
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import transformer as tf
from repro_torch.train import value_and_grad
from repro_torch.train.tree import leaves, named_leaves, tree_map, unflatten

CYCLE = {"granite-3-2b": 2, "gemma3-12b": 6, "internlm2-20b": 2,
         "qwen3-moe-235b-a22b": 1, "grok-1-314b": 1}
BATCH, SEQ, LOSS_CHUNK, AUX_WEIGHT = 1, 256, 128, 0.01
DEFAULT = ("granite-3-2b", "gemma3-12b", "internlm2-20b", "qwen3-moe-235b-a22b")


def _attention64(q, k, v, *, q_offset=0, window=None):
    """Dense causal / windowed attention in q's type (float64)."""
    g = q.shape[2] // k.shape[2]
    kh, vh = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))
    s, t, hd = q.shape[1], k.shape[1], q.shape[-1]
    logits = q.transpose(1, 2) @ kh.transpose(-1, -2) / hd ** 0.5
    qi = q_offset + torch.arange(s)[:, None]
    ki = torch.arange(t)[None, :]
    ok = ki <= qi
    if window is not None:
        ok &= ki > qi - window
    p = torch.softmax(logits.masked_fill(~ok, float("-inf")), dim=-1)
    return (p @ vh).transpose(1, 2)


def _rmsnorm64(x, g, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * g


def _swiglu64(x, w_gate, w_in, w_out):
    return (F.silu(x @ w_gate) * (x @ w_in)) @ w_out


ROUTES = []  # the float64 run's expert choices, a MoE block call each


def _route64(x2d, router, top_k):
    """The router in float64 (its expert choices kept in ROUTES); the gate
    values go on in fp32, the type of the dispatch's capacity buffer."""
    probs = torch.softmax(x2d @ router.to(x2d.dtype), dim=-1)
    gate_vals, gate_idx = M.top_l(probs, top_k)
    ROUTES.append(gate_idx)
    return probs, gate_vals.float(), gate_idx


@contextlib.contextmanager
def forced_route(idx):
    """Patches models.moe.route to take the expert ids ``idx`` (another
    run's choices: a near-tie must not send a token elsewhere) with the gate
    values of this run's router probs at them; ``route.differ`` marks the
    tokens whose own choice differed."""
    original = M.route

    def route(x2d, router, top_k):
        probs, _, own = original(x2d, router, top_k)
        forced = idx.to(own.device)
        route.differ = (forced != own).any(-1).cpu()
        return probs, probs.gather(-1, forced), forced

    route.differ = None
    M.route = route
    try:
        yield route
    finally:
        M.route = original


@contextlib.contextmanager
def float64_islands():
    """The port's fp32-internal pieces replaced by float64 ones."""
    saved = (L.flash_attention, L.rmsnorm, L.swiglu, M.swiglu, L.matmul_f32, M.route)
    L.flash_attention = _attention64
    L.rmsnorm = _rmsnorm64
    L.swiglu = M.swiglu = _swiglu64
    L.matmul_f32 = lambda a, b: a @ b
    M.route = _route64
    try:
        yield
    finally:
        L.flash_attention, L.rmsnorm, L.swiglu, M.swiglu, L.matmul_f32, M.route = saved


def _rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max().clamp_min(1e-300))


@contextlib.contextmanager
def captured_blocks():
    """Patches models.transformer._block_apply to keep each block call's
    (input, output) of the run inside, both keeping their gradients (the
    run must not checkpoint its blocks)."""
    original, seen = tf._block_apply, []

    def block(bp, x, *args, **kwargs):
        y, kv, aux = original(bp, x, *args, **kwargs)
        x.retain_grad()
        y.retain_grad()
        seen.append((x, y))
        return y, kv, aux

    tf._block_apply = block
    try:
        yield seen
    finally:
        tf._block_apply = original


def block_vjp(bp, x, dy, cfg, window, aux_weight: float = AUX_WEIGHT) -> list:
    """[dx, the block's parameter gradients] of one block at ``x`` [B, S, d]
    for the output cotangent ``dy`` (and ``aux_weight`` for its aux loss, as
    lm_loss weighs it)."""
    x = x.detach().requires_grad_(True)
    own = [p.detach().requires_grad_(True) for p in leaves(bp)]
    positions = torch.arange(x.shape[1], device=x.device)
    y, _, aux = tf._block_apply(unflatten(bp, own), x, positions, cfg, window)
    outs, cots = [y], [dy]
    if aux is not None:
        outs.append(aux)
        cots.append(torch.full_like(aux, aux_weight))
    grads = torch.autograd.grad(outs, [x, *own], cots, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip([x, *own], grads)]


def head_vjp(x, final_ln, unembed, labels, cfg) -> tuple:
    """(loss, [dx, d final_ln, d unembed]) of the final norm and the chunked
    cross-entropy (lm_loss's tail) on the hidden state ``x`` [B, S, d]."""
    x, final_ln, unembed = (t.detach().requires_grad_(True) for t in (x, final_ln, unembed))
    h = L.rmsnorm(x, final_ln)
    tot = sum(tf._chunk_nll(hi, li, unembed)
              for hi, li in zip(h.split(cfg.loss_chunk, 1), labels.split(cfg.loss_chunk, 1)))
    loss = tot / labels.numel()
    return loss.detach(), list(torch.autograd.grad(loss, [x, final_ln, unembed]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", help=f"repeatable; default: {', '.join(DEFAULT)}")
    ap.add_argument("--skip-free-run", action="store_true",
                    help="no fp32 free run (its gradients held beside the float64 run's)")
    args = ap.parse_args(argv)
    for aid in args.arch or DEFAULT:
        cfg = dataclasses.replace(get_arch(aid).cfg, n_layers=CYCLE[aid], dtype=torch.float32,
                                  loss_chunk=LOSS_CHUNK, remat=False)
        cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
        toks = np.random.default_rng(4).integers(0, cfg.vocab, (BATCH, SEQ + 1))
        batch = {"tokens": torch.as_tensor(toks[:, :-1]), "labels": torch.as_tensor(toks[:, 1:])}
        p32 = tf.init(cfg, torch.Generator().manual_seed(4), device="cpu")
        if not args.skip_free_run:
            loss32, g32 = value_and_grad(tf.lm_loss)(p32, batch, cfg)
        p64 = tree_map(lambda t: t.double(), p32)
        del p32  # the fp32 weights again from the float64 ones, a block at a time
        gc.collect()
        ROUTES.clear()
        with float64_islands(), captured_blocks() as seen:
            own = [p.requires_grad_(True) for p in leaves(p64)]
            loss64 = tf.lm_loss(p64, batch, cfg64)
            loss64.backward()
        loss64 = loss64.item()
        if not args.skip_free_run:
            free = {n: _rel(a, b.grad) for (n, a), b in zip(named_leaves(g32), own)}
            worst = max(free, key=free.get)
            del g32
            print(f"{aid} layers={cfg.n_layers} B={BATCH} S={SEQ} loss_chunk={LOSS_CHUNK}: free "
                  f"run: loss rel err {abs(float(loss32) - loss64) / abs(loss64):.3g}; worst leaf "
                  f"{worst} {free[worst]:.3g}; "
                  + " ".join(f"{n.replace(chr(39), '')}={e:.2g}" for n, e in free.items()),
                  flush=True)
        for p in own:
            p.grad = None
            p.requires_grad_(False)
        gc.collect()

        blocks = []
        routes = list(ROUTES)
        for i, ((x, y), (_, _, window, bp64)) in enumerate(zip(seen, tf._layers(p64, cfg64))):
            with float64_islands():
                want = block_vjp(bp64, x, y.grad, cfg64, window)
            forced = forced_route(routes[i]) if cfg.is_moe else contextlib.nullcontext()
            with forced:
                got = block_vjp(tree_map(lambda t: t.float(), bp64), x.float(), y.grad.float(),
                                cfg, window)
            blocks.append(max(_rel(a, b) for a, b in zip(got, want)))
            del want, got
        last = seen[-1][1].detach()
        unembed = lambda p: p["embed"].T if cfg.tied_embed else p["unembed"]  # noqa: E731
        with float64_islands():
            l64, h64 = head_vjp(last, p64["final_ln"], unembed(p64), batch["labels"], cfg64)
        l32, h32 = head_vjp(last.float(), p64["final_ln"].float(), unembed(p64).float(),
                            batch["labels"], cfg)
        print(f"{aid}: each block's VJP on the float64 input and cotangent, worst leaf: "
              + " ".join(f"{e:.3g}" for e in blocks)
              + f"; the head: loss rel err {abs(l32.item() - l64.item()) / abs(l64.item()):.3g}, "
              f"dx {_rel(h32[0], h64[0]):.3g}, final_ln {_rel(h32[1], h64[1]):.3g}, unembed "
              f"{_rel(h32[2], h64[2]):.3g}", flush=True)
        del p64, seen, own
        ROUTES.clear()
        gc.collect()


if __name__ == "__main__":
    main()

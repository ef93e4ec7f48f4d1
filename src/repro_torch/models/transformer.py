"""Dense + MoE decoder-only LM, the JAX package's ``models/transformer.py``.

Parameters are plain trees in JAX's layout: the blocks stacked
``[n_rep, P, ...]`` (P = len(window_pattern), the static local / global
attention cycle; gemma3: 5 sliding + 1 global) with JAX's leaf names, so
``convert.params_from_arrays``, ``train.tree.named_leaves`` and the
checkpoint format take an LM tree as they are.  JAX's ``lax.scan`` over
n_rep is a Python loop over views of the stacked leaves.

Entry points:
  init(cfg, generator, device=)          -> params
  forward(params, tokens, cfg, mesh)     -> (logits, aux_loss)
  lm_loss(params, batch, cfg, mesh)      -> scalar loss (differentiable:
                                            attention's backward is the
                                            flash_attn backward kernel)
  init_cache(cfg, batch, max_len)        -> per-pattern KV caches
  serve_prefill(params, tokens, cfg, ..) -> (logits, caches)
  serve_step(params, caches, token, off) -> (logits, caches), the caches
                                            written in place
  specs(cfg), cache_specs(cfg, ..)       -> JAX's PartitionSpec trees

Under ``mesh`` (a ``DeviceMesh``, or None) the parameters are this rank's
shards of ``specs(cfg)`` (``launch.mesh.local_tree``) and the tokens its
batch shard, and every layer does what JAX's GSPMD makes of those specs
(``layers``' and ``moe``'s docstrings): the FSDP axes gathered a layer at a
time, "model" tensor-parallel (Megatron) unless the batch axes
(``layers.batch_axes()``, set by the cells as JAX's are) include it: then
pure FSDP, every weight gathered.  Under tensor parallelism the embedding
is held as ``P("model", None)``: a masked gather of the rank's vocabulary
rows and ``sum_out`` over "model"; the head as ``P(None, "model")``: the
logits of the rank's vocabulary columns (what ``forward``,
``serve_prefill`` and ``serve_step`` return: JAX's ``P(.., "model")``
shard), ``lm_loss``'s log-sum-exp by an all-reduce (max, then sum) over
"model" and the gold logit from the rank that holds it.  ``serve_prefill``
writes this rank's slice of each cache's sequence and ``serve_step``
decodes over it (``cache_axes``: JAX's ``cache_specs`` seq, "model", or
every axis for long-context decode).  ``lm_loss`` under a mesh is the mean
over the batch axes of each rank's loss, each rank's backward its own
term's: ``launch.mesh.grad_mean`` over those axes, by the specs, completes
the gradient (``configs.common.mesh_value_and_grad``).

JAX's XLA layout knobs (``seq_parallel``, ``flash``, ``kv_chunk``,
``attn_chunk``) do not carry over: one ``flash_attention`` call takes a
layer's whole sequence.  ``remat`` does: where a gradient is needed, each
pattern cycle (JAX's ``rep_body``) runs under
``torch.utils.checkpoint.checkpoint`` and keeps only its input, and so does
each chunk of the chunked cross-entropy (JAX's ``@jax.checkpoint
chunk_nll``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import (MODEL_AXIS, P, axis_group, axis_size, check_mesh, copy_in,
                                     max_out, mean_out, sum_out)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.train.tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    # cycle of per-layer attention windows; None = global full attention.
    # gemma3: (W, W, W, W, W, None), 5 local : 1 global.
    window_pattern: Tuple[Optional[int], ...] = (None,)
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_expert_split: int = 1   # store each expert as N ffn column-shards
    capacity_factor: float = 1.25
    tied_embed: bool = False
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True      # checkpoint each pattern cycle where a gradient is needed
    loss_chunk: int = 1024  # 0 = materialize the full [B, S, V] logits

    @property
    def pattern_len(self) -> int:
        return len(self.window_pattern)

    @property
    def n_rep(self) -> int:
        assert self.n_layers % self.pattern_len == 0, (self.n_layers, self.window_pattern)
        return self.n_layers // self.pattern_len

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def param_count(self) -> int:
        """Total parameters (the roofline's 6 N D term)."""
        attn = self.d_model * self.head_dim * (self.n_heads * 2 + self.n_kv * 2)
        if self.is_moe:
            ffn = self.moe_experts * 3 * self.d_model * self.d_ff
            ffn += self.d_model * self.moe_experts
        else:
            ffn = 3 * self.d_model * self.d_ff
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab * self.d_model * (1 if self.tied_embed else 2)
        return self.n_layers * per_layer + embed + self.d_model

    def active_param_count(self) -> int:
        """Activated parameters a token (MoE: top_k of moe_experts)."""
        if not self.is_moe:
            return self.param_count()
        attn = self.d_model * self.head_dim * (self.n_heads * 2 + self.n_kv * 2)
        ffn = self.moe_top_k * 3 * self.d_model * self.d_ff
        ffn += self.d_model * self.moe_experts
        per_layer = attn + ffn + 2 * self.d_model
        embed = self.vocab * self.d_model * (1 if self.tied_embed else 2)
        return self.n_layers * per_layer + embed + self.d_model


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(generator, cfg: TransformerConfig, device):
    p = {"attn": L.attention_init(generator, cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim,
                                  cfg.dtype, device)}
    if cfg.is_moe:
        p["ffn"] = M.moe_init(generator, cfg.d_model, cfg.d_ff, cfg.moe_experts, cfg.dtype,
                              expert_split=cfg.moe_expert_split, device=device)
    else:
        p["ffn"] = L.mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.dtype, device)
    p["ln1"] = L.rmsnorm_init(cfg.d_model, cfg.dtype, device)
    p["ln2"] = L.rmsnorm_init(cfg.d_model, cfg.dtype, device)
    return p


def init(cfg: TransformerConfig, generator=None, *, device="cuda"):
    """The parameter tree, JAX's leaves and dtypes (the router fp32).  The
    stacked blocks are allocated once and drawn a layer at a time (one
    layer's fp32 draw in memory at once); on ``meta`` nothing is drawn.
    The values are the port's own: parity tests carry JAX's across."""
    g = generator if generator is not None else L.make_generator(device)
    shapes = _layer_init(None, cfg, "meta")
    blocks = tree_map(lambda a: torch.empty((cfg.n_rep, cfg.pattern_len, *a.shape),
                                            dtype=a.dtype, device=device), shapes)
    if torch.device(device).type != "meta":
        for r in range(cfg.n_rep):
            for p in range(cfg.pattern_len):
                layer = _layer_init(g, cfg, device)
                for dst, src in zip(leaves(blocks), leaves(layer)):
                    dst[r, p].copy_(src)
                del layer
    params = {
        "embed": L._dense_init(g, (cfg.vocab, cfg.d_model), cfg.dtype, device, scale=1.0),
        "blocks": blocks,
        "final_ln": L.rmsnorm_init(cfg.d_model, cfg.dtype, device),
    }
    if not cfg.tied_embed:
        params["unembed"] = L._dense_init(g, (cfg.d_model, cfg.vocab), cfg.dtype, device)
    return params


def _layer_specs(cfg: TransformerConfig):
    return {"attn": L.attention_specs(), "ffn": M.moe_specs() if cfg.is_moe else L.mlp_specs(),
            "ln1": P(None), "ln2": P(None)}


def _stacked(layer_specs):
    """A layer's specs for the blocks stacked [n_rep, P, ...]."""
    return tree_map(lambda s: P(None, None, *s), layer_specs)


def specs(cfg: TransformerConfig):
    """JAX's PartitionSpec tree of the parameters."""
    out = {"embed": P(MODEL_AXIS, None), "blocks": _stacked(_layer_specs(cfg)),
           "final_ln": P(None)}
    if not cfg.tied_embed:
        out["unembed"] = P(None, MODEL_AXIS)
    return out


def abstract_params(cfg: TransformerConfig):
    """The parameter tree as meta tensors (no allocation)."""
    return init(cfg, device="meta")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _block_trees(params, cfg: TransformerConfig):
    """The stacked blocks as n_rep lists of P block trees.  Each stacked leaf
    is unbound once: under autograd one backward a leaf stacks the layers'
    gradients, where a view ``a[r, p]`` a layer would build a zero tensor of
    the whole stacked leaf for each layer."""
    blocks = params["blocks"]
    flat = [a.flatten(0, 1).unbind(0) for a in leaves(blocks)]
    n = cfg.pattern_len
    return [[unflatten(blocks, [f[r * n + p] for f in flat]) for p in range(n)]
            for r in range(cfg.n_rep)]


def _layers(params, cfg: TransformerConfig):
    """(rep, pattern index, window, block params) in depth order."""
    for r, rep in enumerate(_block_trees(params, cfg)):
        for p, (window, bp) in enumerate(zip(cfg.window_pattern, rep)):
            yield r, p, window, bp


def _block_apply(bp, x, positions, cfg: TransformerConfig, window, mesh=None, kv_cache=None,
                 q_offset=0, cache_axes=(MODEL_AXIS,)):
    h, new_kv = L.attention(bp["attn"], L.rmsnorm(x, bp["ln1"]), positions, n_kv=cfg.n_kv,
                            window=window, kv_cache=kv_cache, q_offset=q_offset,
                            rope_theta=cfg.rope_theta, mesh=mesh, cache_axes=cache_axes)
    x = x + h
    h2 = L.rmsnorm(x, bp["ln2"])
    if cfg.is_moe:
        ff, aux = M.moe_apply(bp["ffn"], h2, n_experts=cfg.moe_experts, top_k=cfg.moe_top_k,
                              capacity_factor=cfg.capacity_factor,
                              expert_split=cfg.moe_expert_split, mesh=mesh)
    else:
        ff, aux = L.mlp(bp["ffn"], h2, mesh), None
    return x + ff, new_kv, aux


def _embed(params, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """The embedding rows of ``tokens`` [B, S]: one ``index_select``, whose
    backward is one ``index_add_`` into the table's gradient (no read-back;
    ``embed[tokens]``'s is a sorting ``index_put_``, and ``F.embedding``'s
    reads a segment count back past 3,072 tokens).  Under tensor
    parallelism the table is this rank's vocabulary rows: the ids outside
    them gather row 0 and are zeroed, then ``sum_out`` over "model"."""
    table = L.gathered(params["embed"], P(MODEL_AXIS, None), mesh)
    tp = L.tp_group(mesh)
    ids = tokens.reshape(-1).long()
    if tp is None:
        return torch.index_select(table, 0, ids).view(*tokens.shape, -1)
    rows = table.shape[0]
    i = ids - tp[1] * rows
    hit = (i >= 0) & (i < rows)
    x = torch.index_select(table, 0, torch.where(hit, i, 0)).masked_fill(~hit[:, None], 0.0)
    return sum_out(x.view(*tokens.shape, -1), tp[0])


def _head(params, cfg: TransformerConfig, mesh=None):
    """(the unembedding [d, V_r] as this rank uses it, the first vocabulary
    id of its columns, the "model" group or None): the whole [d, V] without
    tensor parallelism, else the rank's columns (a tied embedding's rows,
    transposed)."""
    if cfg.tied_embed:
        w = L.gathered(params["embed"], P(MODEL_AXIS, None), mesh).T
    else:
        w = L.gathered(params["unembed"], P(None, MODEL_AXIS), mesh)
    tp = L.tp_group(mesh)
    return (w, 0, None) if tp is None else (w, tp[1] * w.shape[1], tp[0])


def _logits(x: torch.Tensor, head) -> torch.Tensor:
    """``x @ unembed`` in fp32 over the rank's columns (x entering the
    tensor-parallel head through ``copy_in``)."""
    w, _, group = head
    return L.matmul_f32(x if group is None else copy_in(x, group), w)


def _rep_apply(x, rep, positions, cfg: TransformerConfig, mesh=None):
    """One pattern cycle, JAX's ``rep_body``: (x, the cycle's aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for window, bp in zip(cfg.window_pattern, rep):
        x, _, a = _block_apply(bp, x, positions, cfg, window, mesh)
        if a is not None:
            aux = aux + a
    return x, aux


def hidden_states(params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None):
    """The forward up to and with the final norm: ([B, S, d], aux_loss).
    With ``cfg.remat`` and a gradient enabled, each pattern cycle is
    checkpointed (recomputed in the backward, its gathers and collectives
    with it)."""
    check_mesh(mesh)
    s = tokens.shape[1]
    x = _embed(params, tokens, mesh)
    positions = torch.arange(s, device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for rep in _block_trees(params, cfg):
        if remat:
            x, a = checkpoint(_rep_apply, x, rep, positions, cfg, mesh, use_reentrant=False)
        else:
            x, a = _rep_apply(x, rep, positions, cfg, mesh)
        aux = aux + a
    return L.rmsnorm(x, params["final_ln"]), aux


def forward(params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None):
    """tokens [B, S] -> (logits [B, S, V] fp32, aux_loss); under tensor
    parallelism the rank's vocabulary columns [B, S, V / P]."""
    x, aux = hidden_states(params, tokens, cfg, mesh)
    return _logits(x, _head(params, cfg, mesh)), aux


def _token_nll(logits: torch.Tensor, labels: torch.Tensor, lo: int = 0, group=None):
    """``logsumexp(logits) - logits[label]`` a token.  With ``group`` the
    logits are the rank's vocabulary columns from id ``lo``: the max and
    the sum of the shifted exponentials over the group, the gold logit
    from the rank that holds it (zeros elsewhere, summed)."""
    if group is None:
        return torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
    m = max_out(logits.amax(dim=-1), group)
    m = torch.where(torch.isfinite(m), m, 0.0)
    logz = m + torch.log(sum_out(torch.sum(torch.exp(logits - m[..., None]), dim=-1), group))
    i = labels - lo
    hit = (i >= 0) & (i < logits.shape[-1])
    gold = logits.gather(-1, torch.where(hit, i, 0)[..., None])[..., 0].masked_fill(~hit, 0.0)
    return logz - sum_out(gold, group)


def _chunk_nll(x, labels, unembed, lo: int = 0, group=None):
    """The summed next-token NLL of one [B, c] chunk, JAX's ``chunk_nll``."""
    return torch.sum(_token_nll(L.matmul_f32(x, unembed), labels, lo, group))


def lm_loss(params, batch, cfg: TransformerConfig, mesh=None, aux_weight: float = 0.01):
    """batch = {"tokens": [B, S] int, "labels": [B, S] int} -> the mean
    next-token NLL + aux_weight * aux.  With ``loss_chunk`` dividing S
    (and smaller), the cross-entropy runs in sequence chunks of
    [B, loss_chunk, V] fp32 logits, each checkpointed where a gradient is
    enabled (its logits recomputed in the backward).  Under a mesh the
    batch is this rank's shard and the loss the mean over the batch axes."""
    check_mesh(mesh)
    tokens, labels = batch["tokens"], batch["labels"].long()
    b, s = tokens.shape
    if cfg.loss_chunk and s % cfg.loss_chunk == 0 and s > cfg.loss_chunk:
        x, aux = hidden_states(params, tokens, cfg, mesh)
        unembed, lo, group = _head(params, cfg, mesh)
        if group is not None:
            x = copy_in(x, group)
        tot = torch.zeros((), dtype=torch.float32, device=x.device)
        grad = torch.is_grad_enabled()
        for xi, li in zip(x.split(cfg.loss_chunk, dim=1), labels.split(cfg.loss_chunk, dim=1)):
            if grad:
                tot = tot + checkpoint(_chunk_nll, xi, li, unembed, lo, group,
                                       use_reentrant=False)
            else:
                tot = tot + _chunk_nll(xi, li, unembed, lo, group)
        nll = tot / (b * s)
    else:
        x, aux = hidden_states(params, tokens, cfg, mesh)
        head = _head(params, cfg, mesh)
        nll = torch.mean(_token_nll(_logits(x, head), labels, head[1], head[2]))
    loss = nll + aux_weight * aux
    axes = () if mesh is None else tuple(a for a in L.batch_axes() if a in mesh.mesh_dim_names)
    return mean_out(loss, axis_group(mesh, axes)) if axes else loss


# ---------------------------------------------------------------------------
# serving (prefill + decode with per-pattern KV caches)
# ---------------------------------------------------------------------------


def cache_len(cfg: TransformerConfig, window: Optional[int], max_len: int) -> int:
    return max_len if window is None else min(window, max_len)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None, *, device="cuda"):
    """Per-pattern-position KV caches: a tuple over P of (k, v), each
    [n_rep, B, T, n_kv, hd] zeros; sliding-window layers hold only
    ``window`` slots (long_500k's sub-quadratic memory)."""
    dtype = dtype or cfg.dtype
    caches = []
    for window in cfg.window_pattern:
        shape = (cfg.n_rep, batch, cache_len(cfg, window, max_len), cfg.n_kv, cfg.head_dim)
        caches.append((torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device)))
    return tuple(caches)


def cache_specs(cfg: TransformerConfig, batch=("data",), seq=(MODEL_AXIS,)):
    """JAX's shardings of the caches [n_rep, B, T, kv, hd]: batch over
    ``batch``, the sequence over ``seq`` (flash-decoding style); for batch-1
    long-context decode JAX passes batch=() and seq=(every axis,)."""
    b = tuple(batch) if batch else None
    s = tuple(seq) if seq else None
    return tuple((P(None, b, s, None, None), P(None, b, s, None, None))
                 for _ in cfg.window_pattern)


@torch.inference_mode()
def serve_prefill(params, tokens: torch.Tensor, cfg: TransformerConfig, mesh=None,
                  max_len: Optional[int] = None):
    """Run the prompt, fill the caches: (last-token logits [B, V] fp32,
    caches).  ``max_len >= S`` sizes them.  A layer's cache of T slots takes
    the prompt's last T positions at slots 0..T-1 (zeros past S when S < T):
    a ring at its natural slots (position mod T) only when S % T == 0, as
    in the JAX package.  Under a mesh the logits are the rank's vocabulary
    columns and each cache this rank's slice of T along "model" (JAX's
    prefill out_specs)."""
    check_mesh(mesh)
    b, s = tokens.shape
    max_len = max_len or s
    r, n = (0, 1) if mesh is None else (mesh.get_local_rank(MODEL_AXIS),
                                        axis_size(mesh, (MODEL_AXIS,)))
    x = _embed(params, tokens, mesh)
    positions = torch.arange(s, device=x.device)
    caches = []
    for window in cfg.window_pattern:
        t = cache_len(cfg, window, max_len)
        if t % n:
            raise ValueError(f"a cache of {t} slots does not divide into {n} slices")
        shape = (cfg.n_rep, b, t // n, cfg.n_kv, cfg.head_dim)
        caches.append((torch.zeros(shape, dtype=cfg.dtype, device=x.device),
                       torch.zeros(shape, dtype=cfg.dtype, device=x.device)))
    for rep, p, window, bp in _layers(params, cfg):
        x, (k, v), _ = _block_apply(bp, x, positions, cfg, window, mesh)
        t = cache_len(cfg, window, max_len)
        lo, hi = r * (t // n), (r + 1) * (t // n)  # this rank's slots of the cache
        # the prompt's last t positions sit at slots 0..t - 1 (0..S - 1 when S < t)
        first = max(s - t, 0)
        src_lo, src_hi = first + lo, min(first + hi, s)
        if src_hi > src_lo:
            caches[p][0][rep][:, :src_hi - src_lo].copy_(k[:, src_lo:src_hi])
            caches[p][1][rep][:, :src_hi - src_lo].copy_(v[:, src_lo:src_hi])
        del k, v
    x = L.rmsnorm(x[:, -1:], params["final_ln"])
    return _logits(x, _head(params, cfg, mesh))[:, 0], tuple(caches)


@torch.inference_mode()
def serve_step(params, caches, token: torch.Tensor, q_offset: int, cfg: TransformerConfig,
               mesh=None, cache_axes=(MODEL_AXIS,)):
    """One decode step.  token [B, 1]; ``q_offset`` the new token's absolute
    position, a host int (a step reads nothing back).  Each layer writes
    its new k / v into its cache in place at slot ``q_offset % T``.
    Returns (logits [B, V] fp32, caches).  Under a mesh each cache is this
    rank's slice of T along ``cache_axes`` (JAX's ``cache_specs`` seq:
    "model" for decode_32k, every axis for long_500k) and the logits the
    rank's vocabulary columns."""
    check_mesh(mesh)
    q_offset = int(q_offset)
    x = _embed(params, token, mesh)
    positions = torch.full((1,), q_offset, dtype=torch.int64, device=x.device)
    for r, p, window, bp in _layers(params, cfg):
        kv = (caches[p][0][r], caches[p][1][r])
        x, _, _ = _block_apply(bp, x, positions, cfg, window, mesh, kv_cache=kv,
                               q_offset=q_offset, cache_axes=tuple(cache_axes))
    x = L.rmsnorm(x, params["final_ln"])
    return _logits(x, _head(params, cfg, mesh))[:, 0], caches

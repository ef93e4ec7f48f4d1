"""Mixture-of-Experts layer (GShard top-k routing with capacity), the JAX
package's ``models/moe.py``.  Without a mesh, or with a ``model`` axis of
one rank, ``moe_apply`` is JAX's unsharded oracle: ``_dispatch_local``
over all experts.  With a ``model`` axis of P > 1 ranks it is JAX's
expert-parallel ``shard_map`` body (``expert_parallel``): tokens sharded
over the batch axes and replicated over ``model``; each rank holds its E/P
experts (its ``model`` shard), routes its tokens, runs its own experts,
and the partial outputs are summed over ``model`` -- one [T_local, d]
all-reduce a layer, no all-to-all.  Under any mesh a rank holds
``moe_specs``' shards: the router and the experts' d_model dimension cut
over "data" too, gathered just in time over the mesh's other axes
(``launch.mesh.gather_param``, as JAX's ``shard_map`` in_specs gather
them; backward a reduce-scatter).

The dispatch sorts the flat (token, choice) list by expert (stable), ranks
each choice inside its expert's segment, keeps the first ``capacity`` of a
segment, gathers the kept tokens into an [E, capacity, d] buffer, runs the
SwiGLU experts batched, and scatter-adds the gate-weighted outputs back to
their tokens.  On the card that scatter-add is atomic, so the order of a
token's top-k sum differs from the CPU's: hold it to a tolerance.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.similarity import top_l
from repro_torch.launch.mesh import (MODEL_AXIS, P, axis_group, axis_size, check_mesh, copy_in,
                                     gather_param, mean_out, sum_out)
from repro_torch.models.layers import FFN_CHUNK_VALUES, _dense_init, swiglu


def moe_specs():
    """JAX's: experts over "model" (expert parallelism), d_model FSDP over
    "data" (gathered just in time by JAX's dispatch)."""
    return {
        "router": P("data", None),
        "w_gate": P(MODEL_AXIS, "data", None),
        "w_in": P(MODEL_AXIS, "data", None),
        "w_out": P(MODEL_AXIS, None, "data"),
    }


def moe_init(generator, d_model, d_ff, n_experts, dtype=torch.bfloat16, expert_split: int = 1,
             device="cuda"):
    """``expert_split`` > 1 stores each expert as ``split`` column-shards of
    its FFN ([E*split, d, f/split]); splitting is exact for SwiGLU, whose
    ffn dim is elementwise between the gate / in products and the out
    product.  The router is fp32."""
    e_eff = n_experts * expert_split
    f_eff = d_ff // expert_split
    return {
        "router": _dense_init(generator, (d_model, n_experts), torch.float32, device),
        "w_gate": _dense_init(generator, (e_eff, d_model, f_eff), dtype, device),
        "w_in": _dense_init(generator, (e_eff, d_model, f_eff), dtype, device),
        "w_out": _dense_init(generator, (e_eff, f_eff, d_model), dtype, device),
    }


def route(x2d: torch.Tensor, router: torch.Tensor, top_k: int):
    """(router probs [T, E] fp32, gate values [T, k], expert ids [T, k]),
    the top k in ``lax.top_k``'s order (the lower id first among ties)."""
    probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
    gate_vals, gate_idx = top_l(probs, top_k)
    return probs, gate_vals, gate_idx


def _experts(buf: torch.Tensor, w_gate, w_in, w_out) -> torch.Tensor:
    """SwiGLU of each expert over its [capacity, d] rows, in expert chunks
    that keep an [chunk, capacity, f] intermediate under FFN_CHUNK_VALUES."""
    el, cap, d = buf.shape
    step = max(1, FFN_CHUNK_VALUES // max(1, cap * w_gate.shape[-1]))
    if step >= el:
        return swiglu(buf, w_gate, w_in, w_out)
    y = buf.new_empty((el, cap, w_out.shape[-1]))
    for e in range(0, el, step):
        y[e:e + step] = swiglu(buf[e:e + step], w_gate[e:e + step], w_in[e:e + step],
                               w_out[e:e + step])
    return y


def _dispatch_local(x2d: torch.Tensor, router, w_gate, w_in, w_out, expert_lo: int = 0, *,
                    top_k: int, capacity: int, split: int = 1):
    """Route + select + compute + combine over the experts ``w_*`` hold
    (from ``expert_lo``).  Returns (out [T, d], aux_loss)."""
    t, d = x2d.shape
    e = router.shape[1]
    el = w_gate.shape[0]
    dev = x2d.device

    probs, gate_vals, gate_idx = route(x2d, router, top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # Switch-style load-balance aux loss over the full router probs (counts
    # by float adds of 1.0: exact, and no read-back on the card)
    me = probs.mean(dim=0)
    ce = torch.zeros((e,), dtype=torch.float32, device=dev).index_add_(
        0, gate_idx.reshape(-1), torch.ones((t * top_k,), dtype=torch.float32, device=dev))
    aux = e * torch.sum(me * (ce / (t * top_k)))

    if split > 1:
        # route to every column-shard of the chosen expert
        split_ids = torch.arange(split, dtype=gate_idx.dtype, device=dev)
        gate_idx = (gate_idx[..., None] * split + split_ids).reshape(t, top_k * split)
        gate_vals = gate_vals.repeat_interleave(split, dim=-1)
        top_k = top_k * split

    # ---- sort-based ragged dispatch over the flat (token, choice) list ----
    flat_expert = gate_idx.reshape(-1)
    flat_token = torch.arange(t, dtype=torch.int64, device=dev).repeat_interleave(top_k)
    flat_gate = gate_vals.reshape(-1)

    order = torch.argsort(flat_expert, stable=True)
    s_expert = flat_expert[order]
    s_token = flat_token[order]
    s_gate = flat_gate[order]

    # rank within the expert's segment
    idx = torch.arange(t * top_k, dtype=torch.int64, device=dev)
    seg_first = torch.ones_like(s_expert, dtype=torch.bool)
    seg_first[1:] = s_expert[1:] != s_expert[:-1]
    seg_start = torch.cummax(torch.where(seg_first, idx, 0), dim=0).values
    rank = idx - seg_start

    local_e = s_expert - expert_lo
    keep = (rank < capacity) & (local_e >= 0) & (local_e < el)
    slot = torch.where(keep, local_e * capacity + rank, el * capacity)  # spill row

    # token ids and gates into the capacity buffer (the spill row last)
    buf_tok = torch.full((el * capacity + 1,), t, dtype=torch.int64, device=dev)
    buf_tok[slot] = torch.where(keep, s_token, t)
    buf_gate = torch.zeros((el * capacity + 1,), dtype=torch.float32, device=dev)
    buf_gate[slot] = torch.where(keep, s_gate, 0.0)
    buf_tok = buf_tok[: el * capacity]
    buf_gate = buf_gate[: el * capacity]

    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    buf = x_pad[buf_tok].view(el, capacity, d)
    y = _experts(buf, w_gate, w_in, w_out).view(el * capacity, d)

    # combine: gate-weight, one scatter-add back to the token rows
    y = y * buf_gate[:, None].to(y.dtype)
    out = x2d.new_zeros((t + 1, d)).index_add_(0, buf_tok, y)[:t]
    return out, aux


def expert_parallel(x2d: torch.Tensor, router, w_gate, w_in, w_out, model_rank: int,
                    model_group, batch_group=None, *, top_k: int, capacity: int,
                    split: int = 1):
    """JAX's ``shard_map`` body over one rank's experts: its local tokens
    (replicated over the model group) dispatched to its ``w_*`` (the
    (split-)experts from ``model_rank * E_local``), the partial outputs
    summed over the model group; aux averaged over the model group, then
    over ``batch_group`` (the batch axes; None for none).

    Gradients: the tokens and the router enter through ``copy_in`` (each
    rank's cotangent covers only its own experts, so the group sums them)
    and the output leaves through ``sum_out`` (the computation after it is
    replicated over the group: its cotangent passes unchanged).  aux, the
    same on every rank, is ``sum_out`` / P, so the sums of ``copy_in`` count
    its gradient once."""
    p = dist.get_world_size(model_group)
    x_in, router_in = copy_in(x2d, model_group), copy_in(router, model_group)
    out, aux = _dispatch_local(x_in, router_in, w_gate, w_in, w_out,
                               model_rank * w_gate.shape[0], top_k=top_k, capacity=capacity,
                               split=split)
    out = sum_out(out, model_group)
    aux = sum_out(aux, model_group) / p
    if batch_group is not None:
        aux = mean_out(aux, batch_group)
    return out, aux


def moe_apply(params, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25, expert_split: int = 1, mesh=None):
    """x [B, S, d] -> (out [B, S, d], aux_loss).  ``capacity`` is JAX's host
    formula, ``max(8, int(T top_k / n_experts * capacity_factor))`` over the
    T tokens a rank routes.  Under a mesh ``x`` is this rank's batch shard
    and ``params`` its shards of ``moe_specs``, gathered over every axis
    but "model"; with a "model" axis of P > 1 ranks (JAX's branch rule) the
    dispatch is ``expert_parallel`` over the rank's E/P experts."""
    check_mesh(mesh)
    b, s, d = x.shape
    capacity = max(8, int(b * s * top_k / n_experts * capacity_factor))
    if mesh is not None:
        spec = moe_specs()
        axes = tuple(a for a in mesh.mesh_dim_names if a != MODEL_AXIS)
        params = {name: gather_param(params[name], spec[name], mesh, axes) for name in spec}
    if (mesh is not None and MODEL_AXIS in mesh.mesh_dim_names
            and axis_size(mesh, (MODEL_AXIS,)) > 1):
        p = axis_size(mesh, (MODEL_AXIS,))
        e_eff = n_experts * expert_split
        if e_eff % p or params["w_gate"].shape[0] != e_eff // p:
            raise ValueError(f"a rank holds {e_eff} // {p} experts of the {MODEL_AXIS} axis; "
                             f"got {params['w_gate'].shape[0]}")
        batch = tuple(a for a in mesh.mesh_dim_names if a != MODEL_AXIS)
        out, aux = expert_parallel(
            x.reshape(-1, d), params["router"], params["w_gate"], params["w_in"],
            params["w_out"], mesh.get_local_rank(MODEL_AXIS), axis_group(mesh, (MODEL_AXIS,)),
            axis_group(mesh, batch) if batch else None, top_k=top_k, capacity=capacity,
            split=expert_split)
        return out.view(b, s, d), aux
    out, aux = _dispatch_local(x.reshape(-1, d), params["router"], params["w_gate"],
                               params["w_in"], params["w_out"], 0, top_k=top_k,
                               capacity=capacity, split=expert_split)
    return out.view(b, s, d), aux

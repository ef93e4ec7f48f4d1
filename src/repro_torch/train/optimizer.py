"""AdamW and the cosine schedule, with the JAX package's formulas
(``repro.train.optimizer``), as plain functions on trees of tensors.

Moments are fp32 whatever the parameter's dtype.  The update is not
``torch.optim.AdamW`` with ``clip_grad_norm_``: that clips by
``max_norm / (norm + 1e-6)`` and decays before the moment update.  Here the
clip factor is ``min(1, clip / max(norm, 1e-9))``, bias correction uses
``b ** step`` in fp32, ``delta = mhat / (sqrt(vhat) + eps) + wd * p`` and
weight decay applies to every leaf.  ``lr`` may be a 0-dim tensor on the
device: a step reads nothing back.

``adamw_update_`` is the same update written into the params and moments in
place, a slice at a time: the port's counterpart of the JAX cell's donated
params and optimizer state (``donate=(0, 1)``).  Without it the old and new
params and moments live at once at the update.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.launch.mesh import P, axis_group, spec_axes, sum_out
from repro_torch.train.tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor  # [] int32
    mu: Any
    nu: Any


def adamw_init(params) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
    own = leaves(params)
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=own[0].device if own else "cpu"),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def adamw_specs(param_specs) -> AdamWState:
    """The optimizer state's PartitionSpecs mirror the parameters'."""
    return AdamWState(step=P(), mu=param_specs, nu=param_specs)


def global_norm(tree, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, summed leaf by leaf in
    flattening order, in fp32.  With ``specs`` (a PartitionSpec tree) and a
    mesh, a leaf's sum of squares is first summed over the axes its spec
    cuts: the norm of the whole tree whose blocks the ranks hold."""
    sq = None
    own = leaves(tree)
    cuts = [()] * len(own) if specs is None else [
        tuple(a for a in mesh.mesh_dim_names if a in spec_axes(s)) for s in leaves(specs)]
    for g, axes in zip(own, cuts):
        term = torch.sum(torch.square(g.to(torch.float32)))
        if axes:
            term = sum_out(term, axis_group(mesh, axes))
        sq = term if sq is None else sq + term
    return torch.sqrt(sq if sq is not None else torch.zeros(()))


def _update_leaf(p, g, m, v, *, scale, c1, c2, lr, b1, b2, eps, weight_decay):
    g = g.to(torch.float32).mul(scale)
    m = m.mul(b1).add_(g.mul(1.0 - b1))                 # b1 m + (1 - b1) g
    v = v.mul(b2).add_(g.mul(1.0 - b2).mul_(g))         # b2 v + (1 - b2) g g
    del g
    delta = m.div(c1)                                   # mhat
    delta.div_(v.div(c2).sqrt_().add_(eps))             # mhat / (sqrt(vhat) + eps)
    pf = p.to(torch.float32)
    delta.add_(pf.mul(weight_decay))                    # + wd p
    return pf.sub(delta.mul_(lr)).to(p.dtype), m, v     # p - lr delta


def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1, clip: float = 1.0,
                 grad_norm=None):
    """Returns ``(new_params, new_state)``; the inputs are not modified.
    ``grad_norm`` replaces ``global_norm(grads)`` in the clip (a sharded
    tree's norm)."""
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    step = state.step + 1
    sf = step.to(torch.float32)
    c1 = 1.0 - b1 ** sf
    c2 = 1.0 - b2 ** sf
    out = [_update_leaf(p, g, m, v, scale=scale, c1=c1, c2=c2, lr=lr, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay)
           for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                                 leaves(state.nu))]
    return (unflatten(params, [o[0] for o in out]),
            AdamWState(step=step, mu=unflatten(state.mu, [o[1] for o in out]),
                       nu=unflatten(state.nu, [o[2] for o in out])))


# elements of a leaf updated at once by adamw_update_ (its fp32 temporaries
# are a few times this many: 128 MiB each)
UPDATE_SLICE = 1 << 25


@torch.no_grad()
def adamw_update_(grads, state: AdamWState, params, *, lr, b1: float = 0.9, b2: float = 0.95,
                  eps: float = 1e-8, weight_decay: float = 0.1, clip: float = 1.0,
                  grad_norm=None):
    """``adamw_update`` written in place: each leaf of ``params``,
    ``state.mu`` and ``state.nu`` is updated in slices of UPDATE_SLICE
    elements (a stacked leaf in slices along its flattened layers), with
    ``_update_leaf``'s arithmetic, so the values are ``adamw_update``'s bit
    for bit.  Returns ``(params, new_state)``: the same params tree, and a
    state with the new step around the same moment tensors.  ``grad_norm``
    replaces ``global_norm(grads)`` in the clip (a sharded tree's norm)."""
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-9), max=1.0)
    step = state.step + 1
    sf = step.to(torch.float32)
    c1 = 1.0 - b1 ** sf
    c2 = 1.0 - b2 ** sf
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu), leaves(state.nu)):
        if not (p.is_contiguous() and m.is_contiguous() and v.is_contiguous()):
            raise ValueError("adamw_update_ writes contiguous params and moments in place")
        for ps, gs, ms, vs in zip(*(x.reshape(-1).split(UPDATE_SLICE) for x in (p, g, m, v))):
            new_p, new_m, new_v = _update_leaf(ps, gs, ms, vs, scale=scale, c1=c1, c2=c2, lr=lr,
                                               b1=b1, b2=b2, eps=eps,
                                               weight_decay=weight_decay)
            ps.copy_(new_p)
            ms.copy_(new_m)
            vs.copy_(new_v)
            del new_p, new_m, new_v
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def cosine_schedule(step, *, base_lr: float, warmup: int, total: int, min_frac: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine down to ``min_frac *
    base_lr`` at ``total``; ``step`` an int32 tensor (or an int)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(s < warmup, warm, cos)

"""int8 error-feedback gradient compression, the JAX package's
``train/compress.py``: an all-reduce mean whose wire format is int8 codes
and one fp32 scale, with each rank's quantization error fed into its next
step.

Per tensor, over the process group of the data axes:
  1. c = g + e                      (carry the quantization error forward)
  2. s = max(all_reduce_max(max|c|), 1e-12) / 127   (one scalar all-reduce)
  3. q = clip(round(c / s), -127, 127) in int8      (4x fewer bytes than fp32)
  4. mean = all_reduce_sum(int32(q)) * s / n        (n * 127 << 2^31)
  5. e' = c - q * s                 (this rank's error, kept; rounded once)

Every step is JAX's, op for op: elementwise IEEE fp32 and integer sums,
``torch.round`` rounding half to even as ``jnp.round`` does, and step 5
rounded once as JAX's compiled step fuses it, so the port's means and
errors equal JAX's bit for bit, on the CPU and on the card.  The mean
converges to the uncompressed mean as the errors are fed back.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_group
from repro_torch.train.tree import leaves, tree_map, unflatten


def _compress_one(g: torch.Tensor, e: torch.Tensor, group):
    c = g.to(torch.float32) + e
    amax = torch.max(torch.abs(c)).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    # every divisor a tensor on c's device: a CUDA division by a host scalar
    # multiplies by its rounded reciprocal, which is not IEEE division
    div = lambda a, b: a / torch.full((), b, dtype=torch.float32, device=c.device)  # noqa: E731
    scale = div(torch.clamp(amax[0], min=1e-12), 127.0)
    q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    mean = div(total.to(torch.float32) * scale, float(dist.get_world_size(group)))
    # c - q s rounded once, as JAX's compiled step computes it (XLA fuses the
    # multiply and the subtract): in float64 both q s (7 + 24 bits) and the
    # difference (at most s / 2) are exact
    e_new = (c.double() - q.double() * scale.double()).to(torch.float32)
    return mean, e_new


@torch.no_grad()
def compressed_grad_mean(grads, errors, group):
    """The int8 error-feedback all-reduce mean of every leaf of ``grads``
    over ``group`` (the process group of the data axes), the errors
    ``errors`` fed in.  Returns (mean grads, new errors)."""
    out = [_compress_one(g, e, group) for g, e in zip(leaves(grads), leaves(errors))]
    return (unflatten(grads, [m for m, _ in out]), unflatten(errors, [e for _, e in out]))


def error_init(params):
    """Zero errors, fp32, in the parameters' shapes."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def make_compressed_allreduce(mesh, axes: Sequence[str]):
    """The standalone compressed all-reduce mean over the mesh ``axes``:
    ``f(x, e)`` takes this rank's block of JAX's leading shard axis (x and
    e [1, ...], ``local_shard(x, P(axes), mesh)``) and returns the mean
    (the same on every rank) and this rank's new error, each [1, ...]."""
    group = axis_group(mesh, tuple(axes))

    @torch.no_grad()
    def f(x: torch.Tensor, e: torch.Tensor):
        m, e2 = _compress_one(x[0], e[0], group)
        return m[None], e2[None]

    return f

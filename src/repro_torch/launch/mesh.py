"""The mesh, the JAX package's ``launch/mesh.py`` over
``torch.distributed.device_mesh.DeviceMesh``, and the pieces of JAX's
sharding that the port's ``shard_map`` bodies are written with.

A mesh is a ``DeviceMesh`` with JAX's axis names (``pod``, ``data``,
``model``), built over whatever process group is initialized, on ``"cuda"``
unless the caller asks for ``"cpu"``.  Nothing here touches a process group
or a device at import.

  make_production_mesh(multi_pod=)  (16, 16) over (data, model): one pod of
                                    256 ranks; (2, 16, 16) with pod: 512
  make_host_mesh(n_devices, axis)   a 1-D mesh over the first n ranks
  batch_axes_of, data_parallelism   the mesh's batch axes, their size
  P(*entries)                       a PartitionSpec: one entry a tensor
                                    dimension, each None, an axis name or a
                                    tuple of names
  placements(spec, mesh)            the spec as DTensor placements
  local_shard(t, spec, mesh)        this rank's block, cut as JAX tiles
  local_tree(tree, specs, mesh)     the same over a tree
  axis_group(mesh, axes)            the process group spanning ``axes``

The collectives below are the ``shard_map`` bodies' ``all_gather``,
``psum_scatter`` and ``psum``, each with the adjoint its use needs under
autograd (JAX's shard_map transpose picks it from the in / out specs):

  gather_rows / scatter_rows_sum    tiled all-gather of a dimension (dim 0
                                    by default), and the reduce-scatter of
                                    it that is its adjoint (each the
                                    other's backward)
  gather_param                      a parameter held as its spec's shard,
                                    whole along the dimensions cut over
                                    the given axes (FSDP's just-in-time
                                    gather; backward the reduce-scatter)
  copy_in / sum_out                 a tensor entering a computation split
                                    over the group (forward identity,
                                    backward sum) and the sum leaving it
                                    for a computation replicated over the
                                    group (forward sum, backward identity)
  max_out                           the maximum over the group, outside
                                    autograd (a log-sum-exp's shift)
  mean_out                          a loss averaged over data-parallel
                                    replicas; each rank backpropagates its
                                    own term and ``grad_mean`` over the
                                    same axes completes the gradient
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

ALL_AXES = ("pod", "data", "model")
MODEL_AXIS = "model"


def _canonical(entry):
    if isinstance(entry, (tuple, list)):
        return None if not entry else entry[0] if len(entry) == 1 else tuple(entry)
    return entry


class P(tuple):
    """``jax.sharding.PartitionSpec``: entry i says how tensor dimension i
    is cut -- None (replicated), an axis name, or a tuple of names (cut over
    those axes, row-major in that order).  Dimensions past the last entry
    are replicated.  As JAX's, an entry of one name is that name and an
    empty one None.  A P is a leaf of the port's trees (``train.tree``)."""

    tree_leaf = True

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def check_mesh(mesh) -> None:
    """None or a DeviceMesh; anything else raises before any work."""
    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh or None, "
                        f"got {type(mesh).__name__}")


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """(16, 16) = one pod of 256 ranks (data x model); (2, 16, 16) = two
    pods, 512 ranks (pod x data x model).  The pod axis carries only data
    parallelism and the gradient all-reduce.  The world must be that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(n_devices: int | None = None, axis: str = "model",
                   device: str = "cuda") -> DeviceMesh:
    """A 1-D mesh over ranks 0..n-1 (n defaults to the world size)."""
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized process group")
    n = n_devices or dist.get_world_size()
    return DeviceMesh(device, torch.arange(n), mesh_dim_names=(axis,))


def batch_axes_of(mesh: DeviceMesh) -> tuple:
    return tuple(a for a in mesh.mesh_dim_names if a != MODEL_AXIS)


def axis_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    names = mesh.mesh_dim_names
    return math.prod(mesh.shape[names.index(a)] for a in axes)


def data_parallelism(mesh: DeviceMesh) -> int:
    return axis_size(mesh, batch_axes_of(mesh))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: P) -> tuple:
    """Every axis a spec cuts over, in its order."""
    return tuple(a for entry in spec for a in _names(entry))


def _dims(mesh: DeviceMesh, names: Sequence[str]) -> list:
    """The mesh dimensions of ``names``, which must be in the mesh's order
    (a DTensor and a flattened group both cut row-major in mesh order)."""
    mesh_names = mesh.mesh_dim_names
    missing = [a for a in names if a not in mesh_names]
    if missing:
        raise ValueError(f"axes {missing} are not in the mesh {mesh_names}")
    dims = [mesh_names.index(a) for a in names]
    if dims != sorted(set(dims)):
        raise ValueError(f"axes {tuple(names)} must be distinct and in the mesh's order "
                         f"{mesh_names}")
    return dims


def placements(spec: P, mesh: DeviceMesh) -> tuple:
    """The DTensor placements of ``spec``: ``Shard(i)`` on each mesh
    dimension that cuts tensor dimension i, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * mesh.ndim
    used = []
    for dim, entry in enumerate(spec):
        for m in _dims(mesh, _names(entry)):
            if m in used:
                raise ValueError(f"{spec} names the axis {mesh.mesh_dim_names[m]} twice")
            used.append(m)
            out[m] = Shard(dim)
    return tuple(out)


def local_shard(t: torch.Tensor, spec: P, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of ``t`` (a view), as JAX tiles it: dimension i is
    cut into the product of its axes' sizes, and the rank takes the block at
    its row-major coordinate over those axes -- rank r of a flattened
    (pod, data, model) group holds rows [r N / P, (r + 1) N / P)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    for dim, entry in enumerate(spec):
        dims = _dims(mesh, _names(entry))
        if not dims:
            continue
        parts, index = 1, 0
        for m in dims:
            parts *= mesh.shape[m]
            index = index * mesh.shape[m] + coord[m]
        if t.shape[dim] % parts:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide into "
                             f"{parts} blocks ({spec})")
        rows = t.shape[dim] // parts
        t = t.narrow(dim, index * rows, rows)
    return t


def local_tree(tree, specs, mesh: DeviceMesh):
    """``local_shard`` over a tree and its spec tree, each block copied (a
    rank holds its blocks as contiguous tensors of their own)."""
    from repro_torch.train.tree import tree_map

    def block(t, spec):
        return local_shard(t, spec, mesh).clone(memory_format=torch.contiguous_format)

    return tree_map(block, tree, specs)


def axis_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group spanning ``axes`` (in the mesh's order), its group
    ranks row-major over them.  A group of several axes is made once a mesh,
    with every group of that kind made on every rank in the same order, as
    ``new_group`` requires."""
    axes = tuple(axes)
    dims = _dims(mesh, axes)
    if not dims:
        raise ValueError("axis_group needs at least one axis")
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if axes not in cache:
        rest = [m for m in range(mesh.ndim) if m not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(-1, axis_size(mesh, axes)).tolist()
        if any(r != sorted(r) for r in ranks):
            raise ValueError("a group's ranks must rise with its mesh coordinate")
        cache[axes], _ = dist.new_subgroups_by_enumeration(ranks)
    return cache[axes]


# ---------------------------------------------------------------------------
# collectives with their adjoints
# ---------------------------------------------------------------------------


def _all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's blocks of ``dim`` in group-rank order, contiguous."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over the group, this rank's block of ``dim``, contiguous."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group), *x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=op, group=group)
    return x


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterRowsSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _SumOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _MeanOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group) / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_rows(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``all_gather(x, axes, axis=dim, tiled=True)``: the group's blocks of
    ``dim`` in group-rank order; backward reduce-scatters the cotangent."""
    return _GatherRows.apply(x, group, dim)


def scatter_rows_sum(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``: the sum
    over the group, this rank's block of ``dim``; backward all-gathers."""
    return _ScatterRowsSum.apply(x, group, dim)


def gather_param(shard: torch.Tensor, spec: P, mesh: DeviceMesh, axes: Sequence[str]):
    """A parameter held as ``local_shard(w, spec, mesh)``, made whole along
    every dimension that ``spec`` cuts over ``axes`` (``gather_rows`` a
    dimension) and left cut along the others: the all-gather JAX's GSPMD
    inserts for FSDP storage.  Backward reduce-scatters the cotangent (a
    sum over those axes' ranks) back to the shard, so the gradient of a
    weight gathered over batch axes is the sum of the ranks' terms
    (``grad_mean`` divides it; it does not sum it again).  A dimension cut
    over several axes is gathered over all of them or none."""
    for dim, entry in enumerate(spec):
        names = _names(entry)
        cut = tuple(a for a in names if a in axes)
        if not cut:
            continue
        if cut != names:
            raise ValueError(f"{spec}: dimension {dim} is cut over {names}; gather all or none "
                             f"of them, not {cut}")
        shard = gather_rows(shard, axis_group(mesh, cut), dim)
    return shard


def copy_in(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over the group) entering a computation whose parts
    the group's ranks share out: the value unchanged, the cotangent summed
    over the group, so each rank gets the whole gradient of ``x``."""
    return _CopyIn.apply(x, group)


def sum_out(x: torch.Tensor, group) -> torch.Tensor:
    """``psum(x, axes)`` feeding a computation that every rank of the group
    repeats: the sum forward, the cotangent passed through unchanged.

    Not ``torch.distributed.nn.functional.all_reduce``: its backward sums
    the cotangents, and every rank holds the same one here (the downstream
    loss is replicated), so each gradient would come out P times too large.
    """
    return _SumOut.apply(x, group)


@torch.no_grad()
def max_out(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over the group, detached: a log-sum-exp's
    shift, whose gradient cancels."""
    return _all_reduce(x.detach(), group, op=dist.ReduceOp.MAX)


def mean_out(x: torch.Tensor, group) -> torch.Tensor:
    """The mean over the group of each rank's ``x`` (a loss of its own data
    shard).  Backward is the identity: each rank backpropagates its own
    term, and ``grad_mean`` over the same axes turns the ranks' gradients
    into the gradient of the mean."""
    return _MeanOut.apply(x, group)


@torch.no_grad()
def grad_mean(grads, mesh: DeviceMesh, axes: Sequence[str], specs=None):
    """The gradient of a loss that is the mean over the data-parallel
    ``axes`` of each rank's term, from each rank's gradient of its own term
    (``mean_out``): each leaf summed over the axes of ``axes`` that its
    spec (in ``specs``, a PartitionSpec tree; none: every leaf whole) does
    not cut, then divided by the size of all of ``axes``.  A leaf cut over
    one of ``axes`` was gathered there in the forward (``gather_param``),
    whose backward already summed it over that axis.  In place where a
    leaf is contiguous; a strided leaf is copied out first: DIEN's gate
    weights' gradients are column slices of one gradient of their
    concatenation, and gloo's all-reduce of such a slice sums its
    neighbours' columns too (each leaf P times over, P the group's size)."""
    from repro_torch.train.tree import leaves, unflatten

    axes = tuple(axes)
    n = axis_size(mesh, axes)
    own = leaves(grads)
    cuts = [()] * len(own) if specs is None else [spec_axes(s) for s in leaves(specs)]
    out = []
    for g, cut in zip(own, cuts):
        rest = tuple(a for a in axes if a not in cut)
        if rest:
            if not g.is_contiguous():
                g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=axis_group(mesh, rest))
        out.append(g.div_(n))
    return unflatten(grads, out)

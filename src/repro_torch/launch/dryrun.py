"""The dry-run: what one rank of a production mesh holds, computes and sends
for each (arch x shape) cell, without a card -- the JAX package's
``launch/dryrun.py`` for the port.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch internlm2-20b \\
      --shape train_4k --mesh both --out experiments/dryrun_torch

Each cell runs once, eagerly, as rank 0 of a fake process group of 256
(``16x16``) or 512 (``2x16x16``) ranks
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once), on meta tensors: the cell is built by ``build_cell(shape,
device="meta", mesh=)`` and the rank's arguments are ``local_tree`` of its
``in_specs``.  The step runs inside ``kernels._lib.recording()`` (a kernel
launch records its cost function's flops and bytes and launches nothing)
and under two dispatch modes, which see every operator the eager port runs,
its backward included:

  * ``OpCounter``: flops by the operands' type (bf16, fp32, tf32) from
    ``torch.utils.flop_counter``'s formulas for the matrix-product family
    plus the recorded kernels' flops (elementwise flops are not counted,
    JAX's rule); bytes by JAX's rules (``launch/roofline.py``) applied to
    the operators that run: a view 0, an allocation 0, a gather, an
    ``index_select``, an ``embedding`` or a slice copied out or in twice
    the result, a scatter, ``index_add_`` or ``index_put_`` twice the
    update, every other operator its operands and its result, plus the
    recorded kernels' bytes; and the collectives (``c10d`` operators) by
    kind: ops, result bytes and wire bytes (JAX's ring factors, a
    reduce-scatter measured by its operand).
  * ``MemTracker`` (``torch.distributed._tools.mem_tracker``), with the
    arguments tracked as held from the start: ``peak_bytes_per_device`` is
    the rank's argument bytes plus the most the step holds allocated at
    once beside them.  This is not XLA's args + out + temp - alias: an
    eager step frees each temporary when its last reference goes, and no
    buffer is assigned ahead.  ``output_size_in_bytes`` counts the
    outputs, ``alias_size_in_bytes`` those that are argument storage (the
    in-place AdamW), and ``temp_size_in_bytes`` is the rest of the peak,
    so that args + out + temp - alias is the peak.

A record has JAX's keys; ``lower_s`` holds the trace's seconds and
``compile_s`` 0.0.  In place of JAX's optimized HLO the dry-run writes
``<tag>.ops.json.gz``: each operator's (and each kernel's) count, flops and
bytes.  Nothing here touches a card or CUDA, and nothing happens at import.
"""
from __future__ import annotations

import argparse
import gzip
import json
import os
import time
import traceback
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import all_cells, get_arch
from repro_torch.kernels import _lib
from repro_torch.launch.mesh import local_tree, make_production_mesh
from repro_torch.train.tree import leaves

# effective wire-byte multiplier per collective kind (ring algorithms): JAX's
WIRE_FACTOR = {
    "all-reduce": 2.0,       # reduce-scatter + all-gather phases
    "all-gather": 1.0,       # result bytes received
    "reduce-scatter": 1.0,   # the reduced operand
    "all-to-all": 1.0,
}

_aten, _c10d = torch.ops.aten, torch.ops.c10d
# c10d operator -> (kind, the argument whose bytes it moves: JAX counts a
# collective's result, a reduce-scatter's operand)
_COLLECTIVES = {
    _c10d.allreduce_: ("all-reduce", 0),
    _c10d._allgather_base_: ("all-gather", 0),
    _c10d.allgather_into_tensor_coalesced_: ("all-gather", 0),
    _c10d._reduce_scatter_base_: ("reduce-scatter", 1),
    _c10d.reduce_scatter_tensor_coalesced_: ("reduce-scatter", 1),
    _c10d.alltoall_base_: ("all-to-all", 0),
}
_NO_BYTES = {_aten._unsafe_view, _aten.empty, _aten.empty_like, _aten.empty_strided,
             _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh}
_TWICE_RESULT = {_aten.gather, _aten.index, _aten.index_select, _aten.embedding, _aten.take,
                 _aten.copy_, _aten.slice_copy, _aten.narrow_copy, _aten.select_copy}
# scatter -> the argument holding its update
_TWICE_UPDATE = {_aten.scatter: 3, _aten.scatter_: 3, _aten.scatter_add: 3, _aten.scatter_add_: 3,
                 _aten.scatter_reduce: 3, _aten.scatter_reduce_: 3, _aten.index_add: 3,
                 _aten.index_add_: 3, _aten.index_copy: 3, _aten.index_copy_: 3,
                 _aten.index_put: 2, _aten.index_put_: 2, _aten._index_put_impl_: 2,
                 _aten.slice_scatter: 1, _aten.select_scatter: 1, _aten.masked_scatter: 2}
_PRODUCT_OPERAND = {_aten.addmm: 1, _aten.baddbmm: 1}  # else the first argument


def flop_class(dtype: torch.dtype) -> str:
    """The rate a product of ``dtype`` runs at on the card (TF32 is off, so
    an fp32 product runs on the fp32 units)."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype == torch.float32:
        return "fp32"
    return str(dtype).replace("torch.", "")


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for e in x for t in _tensors(e)]
    return []


def _nbytes(*xs) -> int:
    """The bytes of the tensors in ``xs`` (nested lists and tuples)."""
    return sum(t.numel() * t.element_size() for x in xs for t in _tensors(x))


class OpCounter(TorchDispatchMode):
    """Counts flops, bytes and collectives of every operator it sees (the
    rules are in the module's docstring)."""

    def __init__(self) -> None:
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_fns = flop_registry
        self.flops_by_dtype = defaultdict(float)
        self.bytes = 0.0
        self.ops = defaultdict(lambda: dict(count=0, flops=0.0, bytes=0.0))
        self.collectives = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        flops = 0.0
        if packet in self._flop_fns:
            flops = float(self._flop_fns[packet](*args, **kwargs, out_val=out))
            self.flops_by_dtype[flop_class(args[_PRODUCT_OPERAND.get(packet, 0)].dtype)] += flops
        if packet in _COLLECTIVES:
            kind, arg = _COLLECTIVES[packet]
            moved = _nbytes(args[arg])
            c = self.collectives.setdefault(kind, dict(ops=0, result_bytes=0, wire_bytes=0.0))
            c["ops"] += 1
            c["result_bytes"] += moved
            c["wire_bytes"] += moved * WIRE_FACTOR[kind]
            nbytes = moved
        elif packet._qualified_op_name.startswith("c10d::"):
            raise NotImplementedError(f"the dry-run does not count the collective {func}")
        elif func.is_view or packet in _NO_BYTES:
            nbytes = 0
        elif packet in _TWICE_RESULT:
            nbytes = 2 * _nbytes(out)
        elif packet in _TWICE_UPDATE:
            update = args[_TWICE_UPDATE[packet]]
            nbytes = 2 * _nbytes(update if isinstance(update, torch.Tensor) else out)
        else:
            nbytes = _nbytes(args, list(kwargs.values()), out)
        self.bytes += nbytes
        rec = self.ops[str(packet)]
        rec["count"] += 1
        rec["flops"] += flops
        rec["bytes"] += nbytes
        return out

    def add_launches(self, launches) -> None:
        """Fold in the kernel launches ``_lib.recording()`` recorded."""
        for launch in launches:
            self.flops_by_dtype[launch.dtype] += launch.flops
            self.bytes += launch.nbytes
            rec = self.ops[f"kernel:{launch.name}"]
            rec["count"] += 1
            rec["flops"] += launch.flops
            rec["bytes"] += launch.nbytes

    def collective_stats(self) -> dict:
        return {"ops": sum(c["ops"] for c in self.collectives.values()),
                "by_kind": self.collectives,
                "wire_bytes": sum(c["wire_bytes"] for c in self.collectives.values())}


def _storages(tree) -> dict:
    """Each distinct storage of the tree's tensors: its id -> bytes."""
    out = {}
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def trace_step(step_fn, args) -> dict:
    """Run ``step_fn(*args)`` once on meta tensors under the recorder and
    the counting modes: {"memory", "cost", "collectives", "ops"} of one
    rank (the record's fields)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    counter = OpCounter()
    tracker = MemTracker()
    tracker.track_external(*[t for t in leaves(args) if isinstance(t, torch.Tensor)])
    with _lib.recording() as recorder, tracker, counter:
        out = step_fn(*args)
    counter.add_launches(recorder.launches)
    peak = sum(snap["Total"] for snap in tracker.get_tracker_snapshot("peak").values())
    held, made = _storages(args), _storages(out)
    arg_bytes, out_bytes = sum(held.values()), sum(made.values())
    alias = sum(n for k, n in made.items() if k in held)
    memory = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
              "temp_size_in_bytes": peak - arg_bytes - out_bytes + alias,
              "alias_size_in_bytes": alias, "peak_bytes_per_device": peak}
    flops = dict(sorted(counter.flops_by_dtype.items()))
    return {"memory": memory,
            "cost": {"flops": sum(flops.values()), "bytes accessed": counter.bytes,
                     "flops_by_dtype": flops},
            "collectives": counter.collective_stats(),
            "ops": dict(sorted(counter.ops.items()))}


def fake_world(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (another size's group is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def local_args(cell, mesh) -> tuple:
    """The rank's arguments: each tensor argument cut by its spec."""
    return tuple(a if spec is None else local_tree(a, spec, mesh)
                 for a, spec in zip(cell.args, cell.in_specs))


def run_cell(arch_id: str, shape: str, multi_pod: bool, verbose: bool = True,
             ops_path: str | None = None) -> dict:
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.time()
    cell = get_arch(arch_id).build_cell(shape, device="meta", mesh=mesh)
    traced = trace_step(cell.step_fn, local_args(cell, mesh))
    t_trace = time.time() - t0
    if ops_path is not None:
        with gzip.open(ops_path, "wt") as f:
            json.dump(traced["ops"], f, indent=1)
    mem, cost, coll = traced["memory"], traced["cost"], traced["collectives"]
    record = {
        "cell": cell.name,
        "arch": arch_id,
        "shape": shape,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": mesh.size(),
        "lower_s": round(t_trace, 2),
        "compile_s": 0.0,
        "memory": mem,
        "cost": {k: cost[k] for k in ("flops", "bytes accessed", "flops_by_dtype")},
        "collectives": coll,
        "meta": cell.meta,
    }
    if verbose:
        print(f"[dryrun] {cell.name} mesh={record['mesh']}: trace {t_trace:.1f}s, "
              f"flops/dev {cost['flops']:.3e}, bytes/dev {cost['bytes accessed']:.3e}, "
              f"wire/dev {coll['wire_bytes']:.3e} ({coll['ops']} collectives)")
        print(f"         args {mem['argument_size_in_bytes'] / 2**30:.2f} GiB"
              f" + temp {mem['temp_size_in_bytes'] / 2**30:.2f} GiB"
              f" + out {mem['output_size_in_bytes'] / 2**30:.2f} GiB"
              f" - alias {mem['alias_size_in_bytes'] / 2**30:.2f} GiB per device")
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.arch != "all":
        cells = [c for c in cells if c[0] == args.arch]
    if args.shape != "all":
        cells = [c for c in cells if c[1] == args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for multi in meshes:  # one process group a world size
        for arch_id, shape in cells:
            tag = f"{arch_id}__{shape}__{'multi' if multi else 'single'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path):
                print(f"[dryrun] skip (exists): {tag}")
                continue
            try:
                rec = run_cell(arch_id, shape, multi,
                               ops_path=os.path.join(args.out, tag + ".ops.json.gz"))
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
            except Exception:
                failures.append(tag)
                traceback.print_exc()
                with open(path + ".failed", "w") as f:
                    f.write(traceback.format_exc())
    if dist.is_initialized():
        dist.destroy_process_group()
    if torch.cuda.is_initialized():
        failures.append("CUDA was initialized")
    if failures:
        print(f"[dryrun] FAILURES: {failures}")
        raise SystemExit(1)
    print("[dryrun] all requested cells traced OK")


if __name__ == "__main__":
    main()

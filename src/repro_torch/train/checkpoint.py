"""Preemption-safe checkpoints in the JAX package's on-disk format
(``repro.train.checkpoint``), so that a checkpoint written by either
package restores into the other.

Layout:  <dir>/step_<N>/
            shard_0.npz        -- every leaf, keyed by its keystr path
            MANIFEST.json      -- step, leaf names / shapes / dtypes, n_procs
         <dir>/LATEST          -- the committed step

Commit protocol: write into ``step_<N>.tmp/``, fsync, rename the directory
(atomic), then rewrite ``LATEST`` by an atomic replace.  A checkpoint exists
whole or not at all: a killed writer leaves only ``*.tmp`` debris, which
``restore`` ignores and the next save overwrites; a ``LATEST`` ahead of its
commit counts as absent.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from repro_torch.train.tree import named_leaves, unflatten

def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as the array JAX's ``save`` writes: a bfloat16 leaf as its
    16-bit patterns in a 2-byte void array, which is what numpy stores for
    an ``ml_dtypes.bfloat16`` array."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A stored array as a tensor of ``dtype``: 2-byte void arrays are
    bfloat16 bits (either package's save), taken bit for bit."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(dtype)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr).to(dtype)
    return torch.from_numpy(arr.astype(torch.empty((), dtype=dtype).numpy().dtype))


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    named = named_leaves(tree)
    arrays = {name: _to_numpy(leaf) for name, leaf in named}
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)

    manifest = {
        "step": step,
        "n_procs": 1,
        "leaves": {n: {"shape": list(leaf.shape), "dtype": str(leaf.dtype).split(".")[-1]}
                   for n, leaf in named},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit

    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        step = int(f.read().strip())
    if not os.path.isdir(os.path.join(ckpt_dir, f"step_{step:08d}")):
        return None  # pointer ahead of a crashed commit: treat as absent
    return step


def restore(ckpt_dir: str, template, step: Optional[int] = None, *, device=None):
    """``(tree, manifest)``: the checkpoint in the structure of ``template``
    (a tree of tensors, or of meta tensors), each leaf cast to its template
    leaf's dtype and put on ``device`` (default: the template leaf's own
    device; a meta template needs ``device``)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)

    data: dict = {}
    for fname in sorted(os.listdir(d)):
        if fname.startswith("shard_") and fname.endswith(".npz"):
            with np.load(os.path.join(d, fname)) as z:
                for k in z.files:
                    data[k] = z[k]

    out = []
    for name, tmpl in named_leaves(template):
        if name not in data:
            raise KeyError(f"checkpoint missing leaf {name}")
        arr = data[name]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{name}: ckpt {arr.shape} != template {tuple(tmpl.shape)}")
        dev = device if device is not None else tmpl.device
        if torch.device(dev).type == "meta":
            raise ValueError(f"{name}: a meta template needs a device to restore onto")
        out.append(_from_numpy(arr, tmpl.dtype).to(dev))
    return unflatten(template, out), manifest

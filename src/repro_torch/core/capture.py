"""CUDA graph capture of a fixed-shape step: the card's analogue of the JAX
package's ``jax.jit`` with donated carries.

A step is a function of static device buffers that writes its state in
place, and may return tensors.  ``capture`` runs it once eagerly on a side
stream (the warm-up a capture needs; its writes are real, so it is the
first call's work) and then records it as one ``torch.cuda.CUDAGraph`` over
the same buffers.  Every later call copies its inputs into the buffers and
replays the graph inside ``no_sync()``, where a read-back raises.  A capture
or replay that fails raises; nothing falls back to the eager step.

The scan build driver (``build.replay_schedule``), the serving loop's
buckets (``launch/serve_loop.BucketExecutor``) and the upsert batch
(``mutation.MutableIndex``) are captured this way.  On the CPU each of them
runs its step eagerly instead.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, NamedTuple

import torch


class Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph  # replays the step on the buffers it was captured on
    step: Callable               # held with the graph: a replay reads the tensors
    #   the step's closure owns
    warm: Any                    # what the eager warm-up returned
    out: Any                     # what the captured call returned: tensors in the
    #   graph's private pool, rewritten by every replay
    capture_ms: float            # host ms of the capture, its synchronize included


def capture(step: Callable, *buffers: torch.Tensor) -> Captured:
    """Run ``step(*buffers)`` eagerly on a side stream, then capture it as a
    CUDA graph on the same buffers (each capture has its own memory pool)."""
    dev = buffers[0].device
    main = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        warm = step(*buffers)
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.graph(graph):
        out = step(*buffers)
    return Captured(graph, step, warm, out, (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def no_sync():
    """``torch.cuda.set_sync_debug_mode("error")`` inside: a host sync (a
    read-back, a blocking copy) raises.  The mode is restored after."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``.  On the card it goes through
    pinned memory by an asynchronous copy, with no host sync (PyTorch holds
    the pinned block until the copy is done); on the CPU it is the array's
    own tensor."""
    t = torch.as_tensor(x)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def data_ptrs(*operands) -> tuple:
    """The address of every tensor in ``operands`` (tensors, tuples or
    dataclasses of tensors; None gives 0): what a captured graph baked in.
    A graph replayed after one of them was replaced reads the old tensor,
    so its caller compares these before a replay."""
    out = []
    for x in operands:
        if x is None:
            out.append(0)
        elif isinstance(x, torch.Tensor):
            out.append(x.data_ptr())
        elif dataclasses.is_dataclass(x):
            out.extend(data_ptrs(*(getattr(x, f.name) for f in dataclasses.fields(x))))
        else:
            out.extend(data_ptrs(*x))
    return tuple(out)

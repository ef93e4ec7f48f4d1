"""Shared layers: initializers and the dense MLP stack (the recsys subset
of the JAX package's ``models/layers.py``; attention, rope, rmsnorm and the
transformer MLP wait for the LM slice).

Random draws come from an explicit ``torch.Generator``: the draw happens on
the generator's device and the result moves to ``device``, so a CPU
generator gives the same initial values to a CPU and a card run.  On the
``meta`` device nothing is drawn (shapes only).  The values are the port's
own, not JAX's: parity tests carry JAX's arrays across
(``repro_torch.convert.params_from_arrays``).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F


def make_generator(device="cuda", seed: int = 0) -> Optional[torch.Generator]:
    """A generator seeded with ``seed`` on ``device`` (None for meta)."""
    if torch.device(device).type == "meta":
        return None
    return torch.Generator(device=device).manual_seed(seed)


def normal(shape, generator: Optional[torch.Generator], device, scale: float = 1.0,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``N(0, 1) * scale`` in fp32, cast to ``dtype``, on ``device``."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype).to(device)


def _dense_init(generator, shape, dtype, device, scale: Optional[float] = None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal(shape, generator, device, scale if scale is not None else fan_in**-0.5, dtype)


def dense_stack_init(generator, dims: Sequence[int], dtype=torch.float32, device="cuda"):
    """dims = [in, h1, ..., out] -> a list of {"w", "b"} layers."""
    return [{"w": _dense_init(generator, (dims[i], dims[i + 1]), dtype, device),
             "b": torch.zeros((dims[i + 1],), dtype=dtype, device=device)}
            for i in range(len(dims) - 1)]


def dense_stack(layers, x: torch.Tensor, act: Callable = F.relu,
                final_act: bool = False) -> torch.Tensor:
    n = len(layers)
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < n - 1 or final_act:
            x = act(x)
    return x

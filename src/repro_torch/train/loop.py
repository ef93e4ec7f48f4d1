"""Preemption-safe training loop with straggler telemetry
(``repro.train.loop``).

Contract: ``step_fn(state, batch) -> (state, metrics)``; ``state`` is a
tree of tensors holding the params, the optimizer state and anything else
that must survive a restart, and ``metrics`` a dict of 0-dim tensors.  The
data pipeline's state is the step counter (``batch_at(step)`` is a pure
function of the step), so a restore resumes exactly.

  * preemption / crash: every ``ckpt_every`` steps, and at the end, the whole
    state commits atomically (``checkpoint.py``); a restarted run resumes
    from ``LATEST``.
  * stragglers: each step's wall time is tracked with an EWMA; a step slower
    than ``straggler_factor`` x the EWMA is recorded (telemetry only).

The batch is drawn before the clock starts.  A step's one sync is the
read-back of its metrics, which ends its timed region.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.train import checkpoint as ckpt


class TrainResult:
    def __init__(self, state, history, straggler_steps):
        self.state = state
        self.history = history
        self.straggler_steps = straggler_steps


def _read_back(metrics: dict) -> dict:
    """One device-to-host copy of every metric, as Python floats."""
    names = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[n]).to(torch.float32).reshape(())
                        for n in names]).tolist()
    return dict(zip(names, vals))


def run(
    step_fn: Callable,
    init_state,
    stream,
    *,
    n_steps: int,
    ckpt_dir: Optional[str] = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    straggler_factor: float = 3.0,
    verbose: bool = True,
) -> TrainResult:
    state = init_state
    start_step = 0

    if ckpt_dir is not None:
        latest = ckpt.latest_step(ckpt_dir)
        if latest is not None:
            state, _ = ckpt.restore(ckpt_dir, init_state, step=latest)
            start_step = latest
            if verbose:
                print(f"[loop] resumed from step {latest}")

    history = []
    straggler_steps = []
    ewma = None
    for step in range(start_step, n_steps):
        batch = stream.batch_at(step)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        values = _read_back(metrics)
        dt = time.perf_counter() - t0

        if ewma is None:
            ewma = dt
        elif dt > straggler_factor * ewma:
            straggler_steps.append((step, dt, ewma))
            if verbose:
                print(f"[loop] straggler step {step}: {dt:.3f}s vs ewma {ewma:.3f}s")
        ewma = 0.9 * ewma + 0.1 * dt

        history.append(values)
        if verbose and step % log_every == 0:
            print(f"[loop] step {step}: {history[-1]} ({dt*1e3:.1f} ms)")

        if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, state)

    if ckpt_dir is not None and n_steps > start_step:
        ckpt.save(ckpt_dir, n_steps, state)
    return TrainResult(state, history, straggler_steps)

from repro_torch.kernels.beam_step.ops import beam_step, beam_walk
from repro_torch.kernels.beam_step.ref import (
    StepResult,
    WalkResult,
    beam_step_ref,
    beam_walk_ref,
    host_walk,
)

__all__ = ["StepResult", "WalkResult", "beam_step", "beam_step_ref", "beam_walk",
           "beam_walk_ref", "host_walk"]

from repro_torch.kernels.beam_step.ops import beam_step
from repro_torch.kernels.beam_step.ref import StepResult, beam_step_ref

__all__ = ["StepResult", "beam_step", "beam_step_ref"]

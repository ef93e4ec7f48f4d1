"""The training substrate: AdamW and its schedule, checkpoints in the JAX
package's format, and the resumable loop.  ``compress`` (a gradient
all-reduce over mesh axes) waits for the mesh tools (ROADMAP Queue 1)."""
from repro_torch.train.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    adamw_update_,
    cosine_schedule,
    global_norm,
)
from repro_torch.train import checkpoint, loop
from repro_torch.train.tree import value_and_grad

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_", "checkpoint",
           "cosine_schedule", "global_norm", "loop", "value_and_grad"]

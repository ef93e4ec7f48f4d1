"""The training substrate: AdamW and its schedule, checkpoints in the JAX
package's format, the resumable loop, and ``compress``, the int8
error-feedback all-reduce mean of a gradient over a mesh's data axes."""
from repro_torch.train.optimizer import (
    AdamWState,
    adamw_init,
    adamw_update,
    adamw_update_,
    cosine_schedule,
    global_norm,
)
from repro_torch.train import checkpoint, compress, loop
from repro_torch.train.tree import value_and_grad

__all__ = ["AdamWState", "adamw_init", "adamw_update", "adamw_update_", "checkpoint",
           "compress", "cosine_schedule", "global_norm", "loop", "value_and_grad"]

from repro_torch.kernels.flash_attn.ops import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_head,
    flash_attention_lse,
)
from repro_torch.kernels.flash_attn.ref import (
    flash_attention_bwd_ref,
    flash_attention_fwd_ref,
    flash_attention_fwd_residual_ref,
    flash_attention_head_ref,
    flash_attention_ref,
)

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_bwd_ref",
           "flash_attention_fwd_ref", "flash_attention_fwd_residual_ref",
           "flash_attention_head", "flash_attention_head_ref", "flash_attention_lse",
           "flash_attention_ref"]

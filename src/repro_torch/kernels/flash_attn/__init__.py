from repro_torch.kernels.flash_attn.ops import flash_attention, flash_attention_head
from repro_torch.kernels.flash_attn.ref import flash_attention_head_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_head", "flash_attention_head_ref",
           "flash_attention_ref"]

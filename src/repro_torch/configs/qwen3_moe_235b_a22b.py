"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf] — MoE.
94L d_model=4096 64H (GQA kv=4, head_dim=128) per-expert d_ff=1536
vocab=151936, 128 experts top-8."""
from repro_torch.configs.common import LMArch
from repro_torch.models.transformer import TransformerConfig

ARCH = LMArch(
    arch_id="qwen3-moe-235b-a22b",
    cfg=TransformerConfig(
        name="qwen3-moe-235b-a22b",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv=4,
        head_dim=128,
        d_ff=1536,
        vocab=151936,
        moe_experts=128,
        moe_top_k=8,
    ),
)

"""grok-1-314b [hf:xai-org/grok-1; unverified] — MoE.
64L d_model=6144 48H (GQA kv=8, head_dim=128) expert d_ff=32768
vocab=131072, 8 experts top-2."""
from repro_torch.configs.common import LMArch
from repro_torch.models.transformer import TransformerConfig

ARCH = LMArch(
    arch_id="grok-1-314b",
    cfg=TransformerConfig(
        name="grok-1-314b",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv=8,
        head_dim=128,
        d_ff=32768,
        vocab=131072,
        moe_experts=8,
        moe_top_k=2,
        moe_expert_split=2,  # 8 experts x 2 ffn column-shards = 16-way model axis
    ),
)

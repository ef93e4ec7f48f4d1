"""internlm2-20b [arXiv:2403.17297; hf] — dense GQA transformer.
48L d_model=6144 48H (GQA kv=8, head_dim=128) d_ff=16384 vocab=92544."""
from repro_torch.configs.common import LMArch
from repro_torch.models.transformer import TransformerConfig

ARCH = LMArch(
    arch_id="internlm2-20b",
    cfg=TransformerConfig(
        name="internlm2-20b",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv=8,
        head_dim=128,
        d_ff=16384,
        vocab=92544,
    ),
)

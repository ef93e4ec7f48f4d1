"""gemma3-12b [hf:google/gemma-3-1b-pt family; unverified] — dense GQA with
5:1 local:global sliding-window attention (window 1024), 128k-class context.
48L d_model=3840 16H (GQA kv=8, head_dim=256) d_ff=15360 vocab=262144.
Tied embeddings (gemma family).  The 5:1 hybrid makes decode memory
sub-quadratic -> long_500k runs for this arch."""
from repro_torch.configs.common import LMArch
from repro_torch.models.transformer import TransformerConfig

WINDOW = 1024

ARCH = LMArch(
    arch_id="gemma3-12b",
    cfg=TransformerConfig(
        name="gemma3-12b",
        n_layers=48,
        d_model=3840,
        n_heads=16,
        n_kv=8,
        head_dim=256,
        d_ff=15360,
        vocab=262144,
        window_pattern=(WINDOW, WINDOW, WINDOW, WINDOW, WINDOW, None),
        rope_theta=1_000_000.0,
        tied_embed=True,
    ),
)

"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base; hf] — dense GQA.
40L d_model=2048 32H (GQA kv=8, head_dim=64) d_ff=8192 vocab=49155.

vocab is PADDED 49155 -> 49408 (multiple of 256) for 16-way vocab sharding +
MXU alignment — the standard Megatron `make-vocab-size-divisible-by` trick;
the 253 pad ids are never emitted by the tokenizer and their logits are
dead rows."""
from repro_torch.configs.common import LMArch
from repro_torch.models.transformer import TransformerConfig

VOCAB_RAW = 49155
VOCAB_PADDED = 49408

ARCH = LMArch(
    arch_id="granite-3-2b",
    cfg=TransformerConfig(
        name="granite-3-2b",
        n_layers=40,
        d_model=2048,
        n_heads=32,
        n_kv=8,
        head_dim=64,
        d_ff=8192,
        vocab=VOCAB_PADDED,
    ),
)

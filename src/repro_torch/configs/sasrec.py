"""sasrec [arXiv:1808.09781; paper]: self-attentive sequential recsys.
embed_dim=50, 2 blocks, 1 head, seq_len=50; 1M-item corpus for retrieval."""
from repro_torch.configs.common import RecsysArch
from repro_torch.models.recsys.sasrec import SASRecConfig

ARCH = RecsysArch(
    arch_id="sasrec",
    cfg=SASRecConfig(embed_dim=50, n_blocks=2, n_heads=1, seq_len=50, n_items=1_000_000),
)

"""dien [arXiv:1809.03672; unverified]: interest evolution CTR.
embed 18, seq 100, gru_dim 108, AUGRU, MLP 200-80; 1M-item corpus."""
from repro_torch.configs.common import RecsysArch
from repro_torch.models.recsys.dien import DIENConfig

ARCH = RecsysArch(
    arch_id="dien",
    cfg=DIENConfig(embed_dim=18, seq_len=100, gru_dim=108, mlp=(200, 80), n_items=1_000_000),
)

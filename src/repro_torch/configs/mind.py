"""mind [arXiv:1904.08030; unverified]: multi-interest retrieval.
embed 64, 4 interests, 3 capsule-routing iterations; 1M-item corpus."""
from repro_torch.configs.common import RecsysArch
from repro_torch.models.recsys.mind import MINDConfig

ARCH = RecsysArch(
    arch_id="mind",
    cfg=MINDConfig(embed_dim=64, n_interests=4, capsule_iters=3, seq_len=50,
                   n_items=1_000_000),
)

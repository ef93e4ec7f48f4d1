"""dlrm-rm2 [arXiv:1906.00091; paper]: DLRM RM2-scale.
13 dense, 26 sparse (1M-row tables), embed 64, bot 13-512-256-64,
top 512-512-256-1, dot interaction."""
from repro_torch.configs.common import RecsysArch
from repro_torch.models.recsys.dlrm import DLRMConfig

ARCH = RecsysArch(
    arch_id="dlrm-rm2",
    cfg=DLRMConfig(n_dense=13, n_sparse=26, embed_dim=64, n_rows=1_000_000,
                   bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1)),
)

"""meshgraphnet [arXiv:2010.03409; unverified]: encode-process-decode GNN.
15 processor layers, d_hidden=128, sum aggregator, 2-layer MLPs."""
from repro_torch.configs.common import GNNArch
from repro_torch.models.gnn import GNNConfig

ARCH = GNNArch(
    arch_id="meshgraphnet",
    base=GNNConfig(
        name="meshgraphnet",
        n_layers=15,
        d_hidden=128,
        mlp_layers=2,
        aggregator="sum",
    ),
)

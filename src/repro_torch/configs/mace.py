"""mace [arXiv:2206.07697]: n_layers=2 d_hidden=128 l_max=2
correlation_order=3 n_rbf=8, E(3)-equivariant (ACE basis)."""
from .gnn_common import GNNArch
from ..models.mace import MACEConfig

ARCH = GNNArch(
    arch_id="mace",
    base_cfg=MACEConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                        correlation_order=3, n_rbf=8, n_species=16),
    smoke_cfg=MACEConfig(name="mace-smoke", n_layers=2, d_hidden=16, l_max=2,
                         correlation_order=3, n_rbf=4, n_species=8),
)

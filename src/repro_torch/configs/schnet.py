"""schnet [arXiv:1706.08566] (port of ``repro.configs.schnet``): 3
interaction blocks, d_hidden=64, 300 RBF, cutoff 10 Å. BACO does not
apply (the only table is the ~100-row atom-type embedding); the arch runs
without the technique."""
from repro_torch.configs.registry import ArchSpec, gnn_shapes, register
from repro_torch.models.schnet import SchNetConfig


def full_config():
    return SchNetConfig(name="schnet", n_interactions=3, d_hidden=64,
                        n_rbf=300, cutoff=10.0)


def smoke_config():
    return SchNetConfig(name="schnet-smoke", n_interactions=2, d_hidden=16,
                        n_rbf=8, cutoff=5.0)


register(ArchSpec(
    arch_id="schnet", family="gnn",
    full_config=full_config, smoke_config=smoke_config,
    shapes=gnn_shapes(),
    notes="message passing via the CSR gather-sum over edge lists; "
          "minibatch_lg uses the real neighbor sampler in "
          "data/neighbor_sampler.py; graph-benchmark shapes feed dense "
          "node features through an input projection (d_feat)"))

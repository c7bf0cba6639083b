"""lightgcn-baco: the paper's own experimental pipeline (LightGCN + BPR
over BACO-compressed codebooks), port of ``repro.configs.lightgcn_baco``.
Not part of the assigned 40-cell pool; the trainer
(``training/train_loop.py``) runs it end to end."""
from repro_torch.configs.registry import ArchSpec, ShapeSpec, register
from repro_torch.models.lightgcn import LightGCNConfig


def full_config():
    # amazonbook-scale (largest Table 3 dataset)
    return LightGCNConfig(n_users=52643, n_items=91599, dim=64, n_layers=3)


def smoke_config():
    return LightGCNConfig(n_users=500, n_items=400, dim=16, n_layers=2,
                          k_users=60, k_items=50, n_hot_users=2)


register(ArchSpec(
    arch_id="lightgcn-baco", family="cf",
    full_config=full_config, smoke_config=smoke_config,
    shapes=(ShapeSpec("bpr_train", "train", dict(batch=1024)),),
    notes="paper backbone; see training/train_loop.py"))

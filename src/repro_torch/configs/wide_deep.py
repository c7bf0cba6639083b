"""wide-deep [arXiv:1606.07792] (port of ``repro.configs.wide_deep``): 40
sparse fields, d=32, deep MLP 1024-512-256, concat interaction, wide linear
side. Field cardinalities log-spaced 1e3..1e6 (deterministic; the paper
does not pin them)."""
from repro_torch.configs.registry import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import WideDeepConfig


def full_config():
    return WideDeepConfig(name="wide-deep")


def baco_config():
    return WideDeepConfig(name="wide-deep-baco", etc_ratio=0.25)


def smoke_config():
    return WideDeepConfig(name="wide-deep-smoke",
                          vocabs=(500, 3000, 150000), embed_dim=8,
                          mlp=(32, 16), etc_ratio=0.25)


register(ArchSpec(
    arch_id="wide-deep", family="recsys",
    full_config=full_config, smoke_config=smoke_config,
    shapes=recsys_shapes()))

register(ArchSpec(
    arch_id="wide-deep-baco", family="recsys",
    full_config=baco_config, smoke_config=smoke_config,
    shapes=recsys_shapes()))

"""sasrec [arXiv:1808.09781] (port of ``repro.configs.sasrec``): d=50, 2
blocks, 1 head, seq 50, causal self-attention over item history. Item vocab
1M (retrieval_cand shape). `sasrec-baco`: item table BACO-compressed to 1/4
(no user table -> SCU inapplicable)."""
from repro_torch.configs.registry import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import SASRecConfig


def full_config():
    return SASRecConfig(name="sasrec")


def baco_config():
    return SASRecConfig(name="sasrec-baco", etc_ratio=0.25)


def smoke_config():
    return SASRecConfig(name="sasrec-smoke", n_items=2000, embed_dim=16,
                        seq_len=12, etc_ratio=0.25)


register(ArchSpec(
    arch_id="sasrec", family="recsys",
    full_config=full_config, smoke_config=smoke_config,
    shapes=recsys_shapes()))

register(ArchSpec(
    arch_id="sasrec-baco", family="recsys",
    full_config=baco_config, smoke_config=smoke_config,
    shapes=recsys_shapes()))

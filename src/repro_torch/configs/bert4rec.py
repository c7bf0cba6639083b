"""bert4rec [arXiv:1904.06690] (port of ``repro.configs.bert4rec``): d=64, 2
blocks, 2 heads, seq 200, bidirectional masked-item prediction (sampled
softmax at 1M-item vocab). Encoder-only: its serve shapes are batch scoring
(no decode step)."""
from repro_torch.configs.registry import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import BERT4RecConfig


def full_config():
    return BERT4RecConfig(name="bert4rec")


def baco_config():
    return BERT4RecConfig(name="bert4rec-baco", etc_ratio=0.25)


def smoke_config():
    return BERT4RecConfig(name="bert4rec-smoke", n_items=2000, embed_dim=16,
                          seq_len=16, n_mask=3, n_neg=64, etc_ratio=0.25)


register(ArchSpec(
    arch_id="bert4rec", family="recsys",
    full_config=full_config, smoke_config=smoke_config,
    shapes=recsys_shapes()))

register(ArchSpec(
    arch_id="bert4rec-baco", family="recsys",
    full_config=baco_config, smoke_config=smoke_config,
    shapes=recsys_shapes()))

"""dlrm-mlperf [arXiv:1906.00091] (port of ``repro.configs.dlrm_mlperf``):
MLPerf DLRM (Criteo 1TB cardinalities), 13 dense + 26 sparse fields, d=128,
bot 13-512-256-128, top 1024-1024-512-256-1, dot interaction. ~188M
embedding rows.

`dlrm-mlperf` is the faithful full-table baseline; the BACO-compressed
variant (paper technique, ratio 1/4 on every table >=100k rows) is the
separate arch id `dlrm-mlperf-baco` used by §Perf."""
from repro_torch.configs.registry import ArchSpec, recsys_shapes, register
from repro_torch.models.recsys import DLRMConfig


def full_config():
    return DLRMConfig(name="dlrm-mlperf")


def baco_config():
    return DLRMConfig(name="dlrm-mlperf-baco", etc_ratio=0.25)


def smoke_config():
    return DLRMConfig(name="dlrm-smoke",
                      vocabs=(1000, 200, 120000, 37, 4096),
                      embed_dim=16, bot_mlp=(32, 16), top_mlp=(64, 32, 1),
                      etc_ratio=0.25)


register(ArchSpec(
    arch_id="dlrm-mlperf", family="recsys",
    full_config=full_config, smoke_config=smoke_config,
    shapes=recsys_shapes(),
    notes="96.1 GB of f32 tables: more than one 80 GB card holds (it "
          "runs on a mesh: 'vocab' rows over data x model, "
          "launch.steps.rank_bytes); the dot interaction runs the CUDA "
          "kernel (kernels/dot_interaction)"))

register(ArchSpec(
    arch_id="dlrm-mlperf-baco", family="recsys",
    full_config=baco_config, smoke_config=smoke_config,
    shapes=recsys_shapes(),
    notes="paper technique applied: every >=100k-row table becomes a "
          "1/4-size codebook + frozen int32 sketch (statics)"))

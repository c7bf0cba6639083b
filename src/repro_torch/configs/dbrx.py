"""dbrx-132b [hf:databricks/dbrx-base] (port of ``repro.configs.dbrx``):
40L d6144 48H (GQA kv=8) per-expert d_ff=10752, vocab=100352, MoE 16
experts top-4 fine-grained."""
from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def full_config():
    return TransformerConfig(
        name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48,
        n_kv_heads=8, head_dim=128, d_ff=10752, vocab_size=100352,
        block_pattern=("global",), moe=MoEConfig(16, 4, 1.25),
        tie_embed=False, dtype="bfloat16")


def smoke_config():
    return TransformerConfig(
        name="dbrx-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=512,
        block_pattern=("global",), moe=MoEConfig(4, 2, 1.5),
        tie_embed=False, dtype="float32", q_chunk=8, loss_chunk=8)


register(ArchSpec(
    arch_id="dbrx-132b", family="lm",
    full_config=full_config, smoke_config=smoke_config,
    shapes=lm_shapes(
        long_skip="pure full-attention GQA stack: no sub-quadratic path "
                  "for 512k decode (brief rule)"),
    notes="16-expert top-4 MoE; one expert per model-axis chip"))

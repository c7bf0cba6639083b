"""kimi-k2-1t-a32b [arXiv:2501.kimi2] (port of ``repro.configs.kimi_k2``):
61L d7168 64H (GQA kv=8) per-expert d_ff=2048, vocab=163840, MoE 384
experts top-8 (~1T total, 32B active). Optimizer: Adafactor (full Adam
state would not fit HBM)."""
from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import MoEConfig, TransformerConfig


def full_config():
    return TransformerConfig(
        name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
        n_kv_heads=8, head_dim=112, d_ff=2048, vocab_size=163840,
        block_pattern=("global",), moe=MoEConfig(384, 8, 1.25),
        tie_embed=False, dtype="bfloat16")


def smoke_config():
    return TransformerConfig(
        name="kimi-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=32, vocab_size=512,
        block_pattern=("global",), moe=MoEConfig(8, 2, 1.5),
        tie_embed=False, dtype="float32", q_chunk=8, loss_chunk=8)


register(ArchSpec(
    arch_id="kimi-k2-1t-a32b", family="lm",
    full_config=full_config, smoke_config=smoke_config,
    shapes=lm_shapes(
        long_skip="pure full-attention GQA stack (paper-table config): no "
                  "sub-quadratic path for 512k decode (brief rule)"),
    notes="trillion-param MoE; experts sharded 384/16 over model axis (EP); "
          "adafactor optimizer"))

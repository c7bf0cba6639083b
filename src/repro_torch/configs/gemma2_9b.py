"""gemma2-9b [arXiv:2408.00118] (port of ``repro.configs.gemma2_9b``): 42L
d3584 16H (GQA kv=8) d_ff=14336 vocab=256000, local/global alternating,
attn+final logit softcap."""
from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def full_config():
    return TransformerConfig(
        name="gemma2-9b", n_layers=42, d_model=3584, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=14336, vocab_size=256000,
        block_pattern=("local", "global"), window=4096,
        attn_softcap=50.0, final_softcap=30.0, post_norm=True,
        embed_scale=True, tie_embed=True, dtype="bfloat16")


def smoke_config():
    return TransformerConfig(
        name="gemma2-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        block_pattern=("local", "global"), window=8,
        attn_softcap=50.0, final_softcap=30.0, post_norm=True,
        embed_scale=True, tie_embed=True, dtype="float32",
        q_chunk=8, loss_chunk=8)


register(ArchSpec(
    arch_id="gemma2-9b", family="lm",
    full_config=full_config, smoke_config=smoke_config,
    shapes=lm_shapes(long_skip=None),   # alternating local -> run 500k
    notes="1:1 sliding-window:global alternation, logit softcapping"))

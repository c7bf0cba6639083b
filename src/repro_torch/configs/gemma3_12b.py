"""gemma3-12b [hf:google/gemma-3; dense] (port of
``repro.configs.gemma3_12b``): 48L d3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global interleave, 128k context."""
from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def full_config():
    return TransformerConfig(
        name="gemma3-12b", n_layers=48, d_model=3840, n_heads=16,
        n_kv_heads=8, head_dim=256, d_ff=15360, vocab_size=262144,
        block_pattern=("local",) * 5 + ("global",), window=1024,
        qk_norm=True, post_norm=True, rope_theta=1_000_000.0,
        embed_scale=True, tie_embed=True, dtype="bfloat16")


def smoke_config():
    return TransformerConfig(
        name="gemma3-smoke", n_layers=6, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
        block_pattern=("local",) * 5 + ("global",), window=8,
        qk_norm=True, post_norm=True, embed_scale=True, tie_embed=True,
        dtype="float32", q_chunk=8, loss_chunk=8)


register(ArchSpec(
    arch_id="gemma3-12b", family="lm",
    full_config=full_config, smoke_config=smoke_config,
    shapes=lm_shapes(long_skip=None),   # hybrid local:global -> run 500k
    notes="5:1 sliding-window:global; local layers keep window-sized KV "
          "(sub-quadratic long-context, DESIGN.md §5)"))

"""qwen1.5-32b [hf:Qwen/Qwen1.5] (port of ``repro.configs.qwen15_32b``):
64L d5120 40H (MHA kv=40) d_ff=27392 vocab=152064, QKV bias, full
attention, an fp8 (e4m3fn) KV cache."""
from repro_torch.configs.registry import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def full_config():
    return TransformerConfig(
        name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40,
        n_kv_heads=40, head_dim=128, d_ff=27392, vocab_size=152064,
        block_pattern=("global",), qkv_bias=True, tie_embed=False,
        dtype="bfloat16",
        # MHA (kv=40) at 32k x batch 128 is a 5.5 TB bf16 cache; fp8 KV
        # halves it (the reference's choice, kept)
        kv_cache_dtype="float8_e4m3fn")


def smoke_config():
    return TransformerConfig(
        name="qwen-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
        block_pattern=("global",), qkv_bias=True, tie_embed=False,
        dtype="float32", q_chunk=8, loss_chunk=8)


register(ArchSpec(
    arch_id="qwen1.5-32b", family="lm",
    full_config=full_config, smoke_config=smoke_config,
    shapes=lm_shapes(
        long_skip="pure full-attention stack: 512k-token KV decode has no "
                  "sub-quadratic path (brief rule; see DESIGN.md §5)"),
    notes="MHA (kv=40) with QKV bias; 40 heads pad to 48 under 16-way TP"))

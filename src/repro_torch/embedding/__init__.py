from .engine import (EmbeddingEngine, EmbeddingSpec, LookupBackend,
                     available_backends, available_scorers, dedup_keep_mask,
                     embedding_lookup, fused_topk, get_backend, get_scorer,
                     normalize_backend, register_backend, register_scorer)
from .quantize import (dequantize_int8_rows, dequantize_params,
                       params_quantized, quantize_int8_rows, quantize_params)
from .tables import (codebook_lookup, embed_lookup, embedding_bag,
                     init_codebook, init_embedding)

__all__ = ["EmbeddingSpec", "EmbeddingEngine", "LookupBackend",
           "available_backends", "available_scorers", "embedding_lookup",
           "dedup_keep_mask", "fused_topk", "get_backend", "get_scorer",
           "normalize_backend", "register_backend", "register_scorer",
           "init_embedding", "embed_lookup", "init_codebook",
           "codebook_lookup", "embedding_bag", "quantize_int8_rows",
           "dequantize_int8_rows", "quantize_params", "dequantize_params",
           "params_quantized"]

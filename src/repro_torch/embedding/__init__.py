from .engine import (EmbeddingEngine, EmbeddingSpec, LookupBackend,
                     dedup_keep_mask, fused_topk, get_backend, get_scorer,
                     normalize_backend, register_backend, register_scorer)
from .quantize import (dequantize_int8_rows, dequantize_params,
                       params_quantized, quantize_int8_rows, quantize_params)
from .tables import init_codebook

__all__ = ["EmbeddingSpec", "EmbeddingEngine", "LookupBackend",
           "dedup_keep_mask", "fused_topk", "get_backend", "get_scorer",
           "normalize_backend", "register_backend", "register_scorer",
           "init_codebook", "quantize_int8_rows", "dequantize_int8_rows",
           "quantize_params", "dequantize_params", "params_quantized"]

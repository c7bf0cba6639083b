"""int8 symmetric per-row table quantization (port of
``repro.embedding.quantize``).

    scale_r = max|x_r| / 127        (clamped away from zero)
    q_r     = clip(round(x_r / scale_r), -127, 127)

Quantization is host numpy (bitwise the reference's, so quantized
artifacts carry the same bytes); dequantization is one multiply,
``q.float() * scale``, on the serving device.

A quantized params dict carries ``{name}_q`` int8 [R, d] and
``{name}_scale`` f32 [R] in place of each f32 ``{name}`` table;
``dequantize_params`` passes f32 dicts through untouched.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["quantize_int8_rows", "dequantize_int8_rows",
           "quantize_params", "dequantize_params", "params_quantized"]

_TABLE_NAMES = ("user_table", "item_table")


def quantize_int8_rows(x):
    """x [R, d] float -> (q int8 [R, d], scale f32 [R]). Host numpy."""
    x = np.asarray(x, np.float32)
    scale = np.maximum(np.abs(x).max(axis=1), 1e-12) / 127.0
    q = np.clip(np.rint(x / scale[:, None]), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_int8_rows(q: torch.Tensor, scale: torch.Tensor):
    """Inverse of ``quantize_int8_rows`` on the tensors' device."""
    return q.float() * scale.float()[:, None]


def quantize_params(params) -> dict:
    """{"user_table","item_table"} f32 -> the int8 payload dict."""
    out = {}
    for name in _TABLE_NAMES:
        q, scale = quantize_int8_rows(params[name])
        out[name + "_q"] = q
        out[name + "_scale"] = scale
    return out


def params_quantized(params) -> bool:
    return _TABLE_NAMES[0] + "_q" in params


def dequantize_params(params):
    """int8 payload -> f32 tables; f32 params pass through untouched."""
    if not params_quantized(params):
        return params
    return {name: dequantize_int8_rows(params[name + "_q"],
                                       params[name + "_scale"])
            for name in _TABLE_NAMES}

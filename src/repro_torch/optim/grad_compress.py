"""Gradient compression for a data-parallel all-reduce (counterpart of
``repro/optim/grad_compress.py``): bf16 gradients, and int8 with error
feedback (quantize g + e per leaf with a per-leaf scale, carry the
quantization error into the next step)."""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map, unzip


def to_bf16(grads):
    return tree_map(lambda g: g.to(torch.bfloat16), grads)


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def quantize_int8(g: torch.Tensor):
    """Symmetric per-tensor int8: (q int8, scale 0-d f32). Rounds half to
    even, as ``jnp.round`` does."""
    g = g.float()
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor):
    return q.float() * scale


def compress_with_feedback(grads, errors):
    """Returns (tree of (q, scale) pairs, new errors)."""
    def one(g, e):
        corrected = g.float() + e
        q, s = quantize_int8(corrected)
        return (q, s), corrected - dequantize_int8(q, s)

    return unzip(tree_map(one, grads, errors), 2)


"""Shared building blocks (counterpart of ``repro/models/layers.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x, w, eps: float = 1e-6):
    """RMS norm in f32 with a ``(1 + w)`` gain (zero-initialised weights)."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + w.float())).to(dtype)


def dense(x, w, b=None):
    """x: (..., d_in) @ w: (d_in, d_out)."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def swiglu(x, w_gate, w_up, w_down):
    return dense(F.silu(dense(x, w_gate)) * dense(x, w_up), w_down)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin (..., S, head_dim//2) f32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Half-split (rotate_half) rope. x: (B, S, H, D); cos/sin: (B, S, half)
    or (S, half), cast to x's dtype before the multiply."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    c = c.to(x.dtype)
    s = s.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *, dtype, device,
               scale: float | None = None):
    if torch.device(device).type == "meta":  # shapes only (launch/specs.py):
        # the meta draws cost the dry run's 40 cells seconds
        return torch.empty((d_in, d_out), dtype=dtype, device=device)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * (scale if scale is not None else 1.0 / d_in ** 0.5)).to(dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int, *, dtype, device):
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)

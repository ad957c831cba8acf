"""Model API for serving: prefill and lockstep decode_step.

Counterpart of ``repro/models/model.py``. The serve state is
``{"length": int, "layers": [cache per layer]}``; ``length`` stays a
Python int, so no step reads a value back from the card. The caches are
updated in place by ``decode_step``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import rms_norm, rope_cos_sin


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device,
                dtype=torch.float32):
    return T.init_params(cfg, generator=generator, device=device, dtype=dtype)


def embed_input(cfg: ArchConfig, params, batch):
    """batch: (B, S) or (B,) int token ids."""
    return params["embed"][batch.long()]


def unembed(cfg: ArchConfig, params, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def _rope(cfg: ArchConfig, positions):
    return rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


def prefill(cfg: ArchConfig, params, batch, *, capacity: int, plan=None,
            layout: str = "default"):
    """Process the prompt (B, S); returns (last-token logits (B, V), state)."""
    T.check_ported(cfg)
    plan = plan if plan is not None else T.default_plan(cfg)
    x = embed_input(cfg, params, batch)
    s = x.shape[1]
    rope = _rope(cfg, torch.arange(s, device=x.device))
    caches = []
    for p, perm in zip(params["layers"], plan):
        x, c = T.block_prefill(cfg, p, perm, x, rope, capacity=capacity,
                               layout=layout)
        caches.append(c)
    return unembed(cfg, params, x[:, -1]), {"length": s, "layers": caches}


def decode_step(cfg: ArchConfig, params, state, token, *, plan=None,
                do_select: bool = True, layout: str = "default"):
    """One lockstep decode step. token: (B,) int. Returns (logits (B, V),
    state advanced by one token)."""
    plan = plan if plan is not None else T.default_plan(cfg)
    length = state["length"]
    x = embed_input(cfg, params, token)
    # arange, not torch.tensor([length]): a host-to-card copy would
    # synchronise the stream every step
    cos, sin = _rope(cfg, torch.arange(length, length + 1, device=x.device))
    rope1 = (cos[:, None], sin[:, None])  # (1, 1, half)
    caches = []
    for p, perm, c in zip(params["layers"], plan, state["layers"]):
        x, c = T.block_decode(cfg, p, perm, x, rope1, c, length=length,
                              do_select=do_select, layout=layout)
        caches.append(c)
    return unembed(cfg, params, x), {"length": length + 1, "layers": caches}

"""Model API for serving: prefill, prefill_chunk and decode_step.

Counterpart of ``repro/models/model.py``. The serve state is
``{"length": ..., "layers": [cache per layer]}``. On the lockstep path
``length`` is a Python int; in the continuous-batching engine's batched
state it is a (B,) int32 tensor on the state's device, advanced on the
device, so no step reads a value back from the card. The caches are
updated in place by ``prefill_chunk`` and ``decode_step``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import layouts as layoutlib
from repro_torch.core.paging import chunk_positions
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
            layout=layoutlib.DEFAULT):
    """Process the prompt (B, S); returns (last-token logits (B, V), state).
    ``layout`` (a ``core/layouts`` layout) builds the caches in its page
    order, as it does in every step below."""
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


def empty_serve_state(cfg: ArchConfig, batch: int, *, capacity: int, dtype,
                      device):
    """The batched serve state of ``batch`` free slots: (B,) lengths 0 and
    empty caches (a slot's rows are rewritten at admission)."""
    T.check_ported(cfg)
    layers = [T.empty_block_cache(cfg, batch, capacity, dtype=dtype,
                                  device=device) for _ in range(cfg.num_layers)]
    return {"length": torch.zeros(batch, dtype=torch.int32, device=device),
            "layers": layers}


def prefill_chunk(cfg: ArchConfig, params, state, tokens, *, chunk_len,
                  active, plan=None, layout=layoutlib.DEFAULT):
    """Feed one prompt chunk per slot into the batched serve state.

    tokens: (B, C) int, left-aligned chunks padded past ``chunk_len``
    ((B,) valid tokens); ``active`` (B,) bool marks the slots taking a
    chunk (the others append nothing and keep their length). Each slot's
    chunk starts at its ``state["length"]``. Returns (logits (B, V) at each
    slot's last valid chunk position, state): the row of a slot whose
    prompt just completed is its first-token distribution.
    """
    plan = plan if plan is not None else T.default_plan(cfg)
    start = state["length"]
    x = embed_input(cfg, params, tokens)
    b, cch = tokens.shape
    rope = _rope(cfg, chunk_positions(start, cch))  # (B, C, half)
    caches = []
    for p, perm, c in zip(params["layers"], plan, state["layers"]):
        x, c = T.block_prefill_chunk(cfg, p, perm, x, rope, c, start=start,
                                     chunk_len=chunk_len, active=active,
                                     layout=layout)
        caches.append(c)
    new_len = torch.where(active, start + chunk_len, start).to(start.dtype)
    last = (chunk_len.long() - 1).clamp(0, cch - 1)
    x_last = x[torch.arange(b, device=x.device), last]
    return unembed(cfg, params, x_last), {"length": new_len, "layers": caches}


def decode_step(cfg: ArchConfig, params, state, token, *, plan=None,
                do_select: bool = True, layout=layoutlib.DEFAULT, active=None,
                need_select=None):
    """One decode step. token: (B,) int. Returns (logits (B, V), state
    advanced by one token).

    ``state["length"]`` is an int (lockstep) or a (B,) tensor (continuous
    batching), where ``active`` (B,) bool marks the decoding slots (the
    others neither append nor advance; their logits are ignored) and
    ``need_select`` (B,) bool, on a select step, the slots whose share
    window has run out.
    """
    plan = plan if plan is not None else T.default_plan(cfg)
    length = state["length"]
    x = embed_input(cfg, params, token)
    if isinstance(length, torch.Tensor):
        cos, sin = _rope(cfg, length)                # (B, half), on the card
    else:
        # arange, not torch.tensor([length]): a host-to-card copy would
        # synchronise the stream every step
        cos, sin = _rope(cfg, torch.arange(length, length + 1, device=x.device))
    rope1 = (cos[:, None], sin[:, None])  # (1 or B, 1, half)
    caches = []
    for p, perm, c in zip(params["layers"], plan, state["layers"]):
        x, c = T.block_decode(cfg, p, perm, x, rope1, c, length=length,
                              do_select=do_select, layout=layout,
                              active=active, need_select=need_select)
        caches.append(c)
    new_len = length + 1
    if active is not None:
        new_len = torch.where(active, new_len, length).to(length.dtype)
    return unembed(cfg, params, x), {"length": new_len, "layers": caches}

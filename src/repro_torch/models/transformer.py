"""Decoder blocks (counterpart of ``repro/models/transformer.py``).

The attention families are ported: every layer an attention mixer with
a SwiGLU FFN or a mixture of experts (``models/moe.py``), either all
full-attention layers or gemma3's local:global period
(``local_global_ratio`` sliding-window layers, then one global layer).
Parameters are plain dictionaries, one per layer, in the JAX package's
layout (dense weights are (d_in, d_out)); the JAX package's
period-stacked ``blocks/pos{p}`` and remainder ``rem/rem{r}`` leaves become
one flat list (``repro_torch/models/convert.py``). Layer i sits at period
position ``i % period_len(cfg)`` (remainder layers continue the pattern),
and every block function takes that position.

A sliding-window layer (``attn_spec(cfg, pos).window > 0``) keeps a
``{"full": FullCache}`` in every mode, as the reference does: its prefill
is windowed flash attention, its chunks and decode steps attend the whole
cache under a window mask. Global layers take H²EAL's paged and streaming
caches.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import cache as cachelib
from repro_torch.core import hybrid_attention as hattn
from repro_torch.core import layouts as layoutlib
from repro_torch.core import paging
from repro_torch.kernels import ops as kops
from repro_torch.models import moe as moelib
from repro_torch.models.layers import (
    apply_rope,
    dense,
    init_dense,
    init_embed,
    rms_norm,
    swiglu,
)


def period_len(cfg: ArchConfig) -> int:
    if cfg.mixer_pattern:
        return len(cfg.mixer_pattern)
    if cfg.attn_pattern == "local_global":
        return cfg.local_global_ratio + 1
    return 1


def layer_layout(cfg: ArchConfig) -> tuple[int, int]:
    """(num_periods, num_remainder_layers)."""
    p = period_len(cfg)
    return cfg.num_layers // p, cfg.num_layers % p


def check_ported(cfg: ArchConfig) -> None:
    """Raise for the families this port does not serve yet."""
    attention_stack = (not cfg.mixer_pattern and not cfg.embed_frontend_stub
                       and (cfg.d_ff > 0 or cfg.moe.enabled))
    if not attention_stack:
        raise NotImplementedError(
            f"{cfg.name}: only attention stacks (full or local:global, a dense "
            f"or MoE FFN) are ported; other mixers and frontends are ROADMAP "
            f"Queue 1 item 11")


def attn_spec(cfg: ArchConfig, pos: int = 0) -> hattn.AttnSpec:
    """AttnSpec for period position ``pos`` (layer i is at i % period)."""
    window = 0
    if cfg.attn_pattern == "local_global" and not cfg.layer_is_global_attn(pos):
        window = cfg.local_window
    return hattn.AttnSpec(n_q=cfg.num_heads, n_kv=cfg.num_kv_heads,
                          head_dim=cfg.resolved_head_dim, h2=cfg.h2eal,
                          window=window,
                          idle_rows=cfg.moe.enabled and cfg.moe.capacity_factor > 0)


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device,
                dtype=torch.float32):
    """Random-init parameters from ``generator`` (which must live on
    ``device``). Same shapes and scales as the JAX init; not the same
    numbers (tests bridge JAX weights with ``repro_torch/models/convert.py``)."""
    check_ported(cfg)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device)
    dense_ = lambda i, o: init_dense(generator, i, o, **kw)
    layers = []
    for _ in range(cfg.num_layers):  # the same leaves at every position
        p = {
            "ln1": torch.zeros(d, **kw),
            "wq": dense_(d, cfg.num_heads * hd),
            "wk": dense_(d, cfg.num_kv_heads * hd),
            "wv": dense_(d, cfg.num_kv_heads * hd),
            "wo": dense_(cfg.num_heads * hd, d),
            "ln2": torch.zeros(d, **kw),
        }
        if cfg.moe.enabled:
            p["moe"] = moelib.init_moe(generator, cfg, **kw)
        else:
            p["ffn"] = {"w_gate": dense_(d, cfg.d_ff), "w_up": dense_(d, cfg.d_ff),
                        "w_down": dense_(cfg.d_ff, d)}
        if cfg.qkv_bias:
            p["bq"] = torch.zeros(cfg.num_heads * hd, **kw)
            p["bk"] = torch.zeros(cfg.num_kv_heads * hd, **kw)
            p["bv"] = torch.zeros(cfg.num_kv_heads * hd, **kw)
        layers.append(p)
    params = {"embed": init_embed(generator, cfg.vocab_size, d, **kw),
              "layers": layers, "final_norm": torch.zeros(d, **kw)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_(d, cfg.vocab_size)
    return params


def default_plan(cfg: ArchConfig):
    """Per-layer kv-head permutation (retrieval heads first): the identity
    on every layer, written ``None`` so the attention bodies skip the
    reordering."""
    return [None] * cfg.num_layers


def _ffn_apply(cfg: ArchConfig, p, x):
    """The FFN half of a block over every row of x, idle and padded rows
    too: an MoE layer's capacity counts them, as the reference's does."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return x + moelib.moe_ffn(cfg, p["moe"], h)
    f = p["ffn"]
    return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])


def _qkv(cfg: ArchConfig, p, h):
    hd = cfg.resolved_head_dim
    q = dense(h, p["wq"], p.get("bq"))
    k = dense(h, p["wk"], p.get("bk"))
    v = dense(h, p["wv"], p.get("bv"))
    lead = h.shape[:-1]
    return (q.reshape(*lead, cfg.num_heads, hd),
            k.reshape(*lead, cfg.num_kv_heads, hd),
            v.reshape(*lead, cfg.num_kv_heads, hd))


def _has_full_cache(spec: hattn.AttnSpec) -> bool:
    """A window layer, or the full-attention baseline, keeps a FullCache."""
    return not spec.h2.enabled or spec.window > 0


def block_prefill(cfg: ArchConfig, pos: int, p, perm, x, rope, *, capacity: int,
                  layout=layoutlib.DEFAULT):
    """One block over the prompt. x: (B, S, d) -> (x, the layer's cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    spec = attn_spec(cfg, pos)
    q, k, v = _qkv(cfg, p, h)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    b, s = q.shape[:2]
    o = hattn.prefill_attention(spec, q, k, v, perm)
    if not _has_full_cache(spec):
        cache = layout.prefill(spec, k, v, s, capacity, perm)
    else:  # full-attention baseline / sliding-window layer
        full = cachelib.make_full_cache(b, cfg.num_kv_heads, capacity,
                                        spec.head_dim, dtype=k.dtype,
                                        device=k.device)
        full.k[:, :, :s] = k.transpose(1, 2)
        full.v[:, :, :s] = v.transpose(1, 2)
        cache = {"full": full}
    x = x + dense(o.reshape(b, s, -1), p["wo"])
    return _ffn_apply(cfg, p, x), cache


def empty_block_cache(cfg: ArchConfig, pos: int, batch: int, capacity: int, *,
                      dtype, device):
    """The empty serve cache of ``batch`` slots of a block at period position
    ``pos``."""
    spec = attn_spec(cfg, pos)
    if not _has_full_cache(spec):
        paged, stream = hattn.empty_decode_state(spec, batch, capacity,
                                                 dtype=dtype, device=device)
        return {"paged": paged, "stream": stream}
    return {"full": cachelib.make_full_cache(batch, cfg.num_kv_heads, capacity,
                                             spec.head_dim, dtype=dtype,
                                             device=device)}


def block_prefill_chunk(cfg: ArchConfig, pos: int, p, perm, x, rope, cache, *,
                        start, chunk_len, active, layout=layoutlib.DEFAULT):
    """One prompt chunk per slot through one block. x: (B, C, d); ``rope``
    is (cos, sin) at each slot's chunk positions (B, C, half); ``cache`` is
    the block's serve cache, grown in place; start/chunk_len/active: (B,)
    context before the chunk, valid tokens, slots prefilling. Rows past
    chunk_len and inactive slots append nothing and give values the
    caller ignores."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    spec = attn_spec(cfg, pos)
    q, k, v = _qkv(cfg, p, h)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    b, cch = x.shape[:2]
    if "full" not in cache:
        o, cache = layout.prefill_chunk(spec, cache, q, k, v, start, chunk_len,
                                        active, perm=perm)
    else:  # full-attention baseline / window layer: append, attend causally
        full = cachelib.full_cache_append_chunk(cache["full"], k, v, start,
                                                chunk_len, active)
        pos_q = paging.chunk_positions(start, cch)[:, None, :, None]
        key_pos = torch.arange(full.k.shape[2], device=x.device)
        valid = key_pos <= pos_q
        if spec.window > 0:
            valid = valid & (key_pos > pos_q - spec.window)
        valid = valid.expand(b, full.k.shape[1], cch, full.k.shape[2])
        o = kops.chunk_attention(q.contiguous(), full.k, full.v,
                                 valid.contiguous())
        cache = {"full": full}
    x = x + dense(o.reshape(b, cch, -1), p["wo"])
    return _ffn_apply(cfg, p, x), cache


def block_decode(cfg: ArchConfig, pos: int, p, perm, x, rope1, cache, *, length,
                 do_select: bool, layout=layoutlib.DEFAULT, active=None,
                 need_select=None):
    """Decode one token through one block. x: (B, d). ``length`` is an int
    (lockstep) or (B,) tensor (continuous batching, with the per-slot
    ``active`` and ``need_select`` masks of ``decode_attention``)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    spec = attn_spec(cfg, pos)
    q, k, v = _qkv(cfg, p, h)
    cos1, sin1 = rope1  # (1 or B, 1, half) at each slot's position
    q = apply_rope(q[:, None], cos1, sin1)[:, 0]
    k = apply_rope(k[:, None], cos1, sin1)[:, 0]
    if "full" in cache:
        o, full = hattn.full_decode_attention(spec, q, k, v, cache["full"],
                                              length, active)
        cache = {"full": full}
    else:
        o, cache = layout.decode(spec, cache, q, k, v, length,
                                 do_select=do_select, perm=perm, active=active,
                                 need_select=need_select)
    x = x + dense(o.reshape(o.shape[0], -1), p["wo"])
    return _ffn_apply(cfg, p, x), cache


def block_verify_chunk(cfg: ArchConfig, pos: int, p, perm, x, rope, cache, *, start,
                       active, need_select, layout=layoutlib.DEFAULT):
    """k drafted tokens through one block as k decode steps in one chunk,
    the block's KV caches unchanged (``layouts.dispatch_verify_chunk``: the
    selection and importance refresh only). x: (B, k, d); ``rope`` is (cos,
    sin) at positions start .. start+k-1. Returns (x, cache, (k_roped, v)):
    the chunk's KV, kept for ``block_verify_append`` to commit once the
    accepted length is known. The engine serves speculation on dense
    full-attention stacks only (not ``local_global``, as the JAX engine),
    so there is no other mixer or window layer here."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    spec = attn_spec(cfg, pos)
    q, k, v = _qkv(cfg, p, h)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    b, kch = x.shape[:2]
    o, cache = layoutlib.dispatch_verify_chunk(
        layout, spec, cache, q, k, v, start, active=active,
        need_select=need_select, perm=perm)
    x = x + dense(o.reshape(b, kch, -1), p["wo"])
    return _ffn_apply(cfg, p, x), cache, (k, v)


def block_verify_append(cfg: ArchConfig, pos: int, perm, cache, kv, *, start,
                        accepted, active, layout=layoutlib.DEFAULT):
    """Commit the accepted prefix of a verified chunk into one block's
    caches from the (k_roped, v) of ``block_verify_chunk``."""
    k, v = kv
    return layoutlib.dispatch_verify_append(layout, attn_spec(cfg, pos), cache, k, v,
                                            start, accepted, active=active,
                                            perm=perm)

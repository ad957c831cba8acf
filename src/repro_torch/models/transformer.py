"""Decoder blocks (counterpart of ``repro/models/transformer.py``).

Every mixer of the JAX package is ported: attention layers with a SwiGLU
FFN or a mixture of experts (``models/moe.py``), either all full-attention
layers or gemma3's local:global period (``local_global_ratio``
sliding-window layers, then one global layer); and the recurrent mixers,
mamba2 (``models/ssm.py``; zamba2's period of five mamba2 layers and one
attention layer) and xLSTM's mLSTM and sLSTM (``models/xlstm.py``), each
layer with an FFN only where ``cfg.layer_has_ffn``. A frontend-stub arch
(``embed_frontend_stub``: internvl2-1b, musicgen-large) is a dense stack
fed precomputed embeddings, so it has no ``embed`` leaf.
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
caches. A recurrent layer keeps ``{"ssm": Mamba2State}`` or ``{"xl":
MLSTMState | SLSTMState}`` (``core/cache.py``): its chunk and decode steps
compute the new state as the reference's functions do and write it into
those tensors in place (the rows of slots not stepping left as they are,
the reference's ``_keep_active``), so that a captured step advances the
engine's own buffers. The default layouts own only the attention caches;
a GSPMD layout placed on a rank (``core/layouts.PlacedLayout``) holds the
rank's block of every layer's cache, ``layer_spec`` naming each layer's
kind: H²EAL pages and ring, a full cache cut over rows and kv heads, a
recurrent state cut over rows, stepped on the rank's rows (``rows``).

The training forward, the lockstep prefill and the decode step take
``tp``, a ``runtime/tensor_parallel.TensorParallel`` of the block's
parameters where they are cut over a mesh (None: whole weights, the path
as it always was): q, k and v column-cut and gathered, the attention on
whole heads, ``wo`` row-cut; the FFN Megatron's column / row pair; a MoE
layer expert parallel (``moe.moe_ffn``); a recurrent mixer its projections
gathered, run whole, ``out_proj`` row-cut (``ssm.py``, ``xlstm.py``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import (
    MIXER_ATTENTION,
    MIXER_MAMBA2,
    MIXER_MLSTM,
    MIXER_SLSTM,
    ArchConfig,
)
from repro_torch.core import cache as cachelib
from repro_torch.core import gating as gatinglib
from repro_torch.core import hybrid_attention as hattn
from repro_torch.core import layouts as layoutlib
from repro_torch.kernels import ops as kops
from repro_torch.models import moe as moelib
from repro_torch.models import ssm as ssmlib
from repro_torch.models import xlstm as xlstmlib
from repro_torch.models.layers import (
    apply_rope,
    dense,
    init_dense,
    init_embed,
    rms_norm,
    swiglu,
)
from repro_torch.runtime import tensor_parallel as tplib


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


_MIXERS = (MIXER_ATTENTION, MIXER_MAMBA2, MIXER_MLSTM, MIXER_SLSTM)


def check_ported(cfg: ArchConfig, layout=None) -> None:
    """Raise for a mixer that is not one of the reference's (every family of
    the reference is ported: ROADMAP Queue 1 item 11), and, on a GSPMD
    layout, for a frontend-stub arch (``layouts.check_gspmd_config``)."""
    unknown = sorted(set(cfg.mixer_pattern) - set(_MIXERS))
    if unknown:
        raise NotImplementedError(
            f"{cfg.name}: mixers {unknown} are not the reference's; the port serves "
            f"the attention, mamba2, mLSTM and sLSTM mixers (ROADMAP Queue 1 item 11)")
    if layout is not None and layout.gspmd:
        layoutlib.check_gspmd_config(cfg)


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
    numbers (tests bridge JAX weights with ``repro_torch/models/convert.py``).
    On the meta device ``generator`` may be None: shapes and dtypes only
    (``launch/specs.py``). A frontend-stub arch has no ``embed`` leaf."""
    check_ported(cfg)
    if generator is None and torch.device(device).type != "meta":
        raise ValueError("init_params needs a generator off the meta device")
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device)
    dense_ = lambda i, o: init_dense(generator, i, o, **kw)
    layers = []
    for i in range(cfg.num_layers):
        mixer = cfg.mixer_for_layer(i)
        p = {"ln1": torch.zeros(d, **kw)}
        if mixer == MIXER_ATTENTION:
            p.update(wq=dense_(d, cfg.num_heads * hd), wk=dense_(d, cfg.num_kv_heads * hd),
                     wv=dense_(d, cfg.num_kv_heads * hd), wo=dense_(cfg.num_heads * hd, d))
            if cfg.qkv_bias:
                p["bq"] = torch.zeros(cfg.num_heads * hd, **kw)
                p["bk"] = torch.zeros(cfg.num_kv_heads * hd, **kw)
                p["bv"] = torch.zeros(cfg.num_kv_heads * hd, **kw)
        else:
            r = _RECURRENT[mixer]
            p[r.pkey] = r.init_params(generator, cfg, **kw)
        if cfg.layer_has_ffn(i):
            p["ln2"] = torch.zeros(d, **kw)
            if cfg.moe.enabled:
                p["moe"] = moelib.init_moe(generator, cfg, **kw)
            else:
                p["ffn"] = {"w_gate": dense_(d, cfg.d_ff), "w_up": dense_(d, cfg.d_ff),
                            "w_down": dense_(cfg.d_ff, d)}
        layers.append(p)
    params = ({} if cfg.embed_frontend_stub
              else {"embed": init_embed(generator, cfg.vocab_size, d, **kw)})
    params.update(layers=layers, final_norm=torch.zeros(d, **kw))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_(d, cfg.vocab_size)
    return params


def default_plan(cfg: ArchConfig):
    """Per-layer kv-head permutation (retrieval heads first): the identity
    on every layer, written ``None`` so the attention bodies skip the
    reordering."""
    return [None] * cfg.num_layers


def _ffn_apply(cfg: ArchConfig, pos: int, p, x, tp=None):
    """The FFN half of a block over every row of x, idle and padded rows
    too: an MoE layer's capacity counts them, as the reference's does. A
    layer without an FFN (mamba2 at zamba2, every xLSTM layer) passes x on.
    ``tp``: the block's ``TensorParallel`` (None: whole weights)."""
    if not cfg.layer_has_ffn(pos):
        return x
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return x + moelib.moe_ffn(cfg, p["moe"], h, None if tp is None else tp.at("moe"))
    f = p["ffn"]
    if tp is not None:
        return x + tplib.swiglu(tp.at("ffn"), h, f)
    return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])


def _qkv(cfg: ArchConfig, p, h, tp=None):
    """q, k, v (..., heads, head_dim); over a mesh (``tp``) their columns
    are cut and gathered whole, wherever the cut falls in a head."""
    hd = cfg.resolved_head_dim
    if tp is None:
        q = dense(h, p["wq"], p.get("bq"))
        k = dense(h, p["wk"], p.get("bk"))
        v = dense(h, p["wv"], p.get("bv"))
    else:
        (q, k, v), _ = tplib.columns(tp, h, p, ("wq", "wk", "wv"), ("bq", "bk", "bv"),
                                     gather=True)
    lead = h.shape[:-1]
    return (q.reshape(*lead, cfg.num_heads, hd),
            k.reshape(*lead, cfg.num_kv_heads, hd),
            v.reshape(*lead, cfg.num_kv_heads, hd))


def _out(p, o, tp=None):
    """The attention output's ``wo`` product, row-cut over a mesh: the rank's
    feature block of the whole-head output, summed over 'model'."""
    return dense(o, p["wo"]) if tp is None else tplib.row(tp, o, p, "wo")


def _mamba2_prefill_with_state(cfg: ArchConfig, p, h, tp=None):
    """The chunked forward and the exact final SSM / conv state."""
    return (ssmlib.mamba2_forward(cfg, p, h, tp),
            ssmlib.mamba2_final_state(cfg, p, h, tp))


class _Recurrent(NamedTuple):
    """A recurrent mixer: its cache key, parameter key and state container,
    and the reference's functions over it (each takes ``tp``, the mixer's
    view over a mesh, last)."""
    key: str
    pkey: str
    state_cls: type
    init_params: Callable  # (generator, cfg, *, dtype, device) -> params
    forward: Callable  # (cfg, p, h) -> y, the training forward
    prefill: Callable  # (cfg, p, h) -> (y, state) from a fresh state
    chunk: Callable
    step: Callable
    init_state: Callable  # (cfg, batch, dtype, device) -> state


_RECURRENT = {
    MIXER_MAMBA2: _Recurrent(
        "ssm", "mamba", cachelib.Mamba2State, ssmlib.init_mamba2,
        ssmlib.mamba2_forward, _mamba2_prefill_with_state,
        ssmlib.mamba2_prefill_chunk, ssmlib.mamba2_step,
        lambda cfg, b, dtype, device: ssmlib.init_mamba2_state(cfg, b, dtype=dtype,
                                                               device=device)),
    MIXER_MLSTM: _Recurrent(
        "xl", "xl", cachelib.MLSTMState, xlstmlib.init_mlstm,
        xlstmlib.mlstm_forward, xlstmlib.mlstm_forward_with_state,
        xlstmlib.mlstm_prefill_chunk, xlstmlib.mlstm_step,
        lambda cfg, b, dtype, device: xlstmlib.init_mlstm_state(cfg, b, device=device)),
    MIXER_SLSTM: _Recurrent(
        "xl", "xl", cachelib.SLSTMState, xlstmlib.init_slstm,
        xlstmlib.slstm_forward, xlstmlib.slstm_forward_with_state,
        xlstmlib.slstm_prefill_chunk, xlstmlib.slstm_step,
        lambda cfg, b, dtype, device: xlstmlib.init_slstm_state(cfg, b, device=device)),
}


@functools.lru_cache(maxsize=None)
def layer_spec(cfg: ArchConfig, pos: int):
    """The kind of serve cache of the layer at period position ``pos``, as
    the GSPMD layouts place it: its ``AttnSpec`` (H²EAL's caches, or a full
    cache) or, for a recurrent mixer, its ``cache.RecurrentSpec``."""
    mixer = cfg.mixer_for_layer(pos)
    if mixer == MIXER_ATTENTION:
        return attn_spec(cfg, pos)
    r = _RECURRENT[mixer]
    st = r.init_state(cfg, 1, torch.float32, "meta")
    return cachelib.RecurrentSpec(r.key, r.state_cls,
                                  tuple((n, tuple(t.shape[1:])) for n, t in st.items()))


def _mixer_tp(tp, r: _Recurrent):
    return None if tp is None else tp.at(r.pkey)


def _recurrent_prefill(cfg: ArchConfig, mixer: str, p, h, tp=None):
    """A recurrent layer over the prompt from a fresh state: (y, its cache)."""
    r = _RECURRENT[mixer]
    y, st = r.prefill(cfg, p[r.pkey], h, tp=_mixer_tp(tp, r))
    return y, {r.key: r.state_cls(**st)}


def _recurrent_step(cfg: ArchConfig, pos: int, p, h, cache, keep, chunk=None,
                    layout=layoutlib.DEFAULT, tp=None):
    """A recurrent layer's chunk (``chunk`` = (chunk_len, active)) or decode
    step: the reference's function on the layer's state, the new state
    written into the cache's tensors in place (decode: the rows where
    ``keep``, as the reference's ``_keep_active``; a chunk leaves the rows of
    slots without tokens as they were by its own arithmetic). Under a GSPMD
    layout the state is the rank's rows, stepped on those rows of ``h``, and
    y is gathered whole (``layout.rows``). Returns y."""
    r = _RECURRENT[cfg.mixer_for_layer(pos)]
    clen, act = chunk if chunk is not None else (None, None)
    mtp = _mixer_tp(tp, r)

    def run(h, keep, clen, act):
        st = cachelib.state_fields(cache[r.key])
        if chunk is not None:
            y, new = r.chunk(cfg, p[r.pkey], st, h, chunk_len=clen, active=act, tp=mtp)
        else:
            y, new = r.step(cfg, p[r.pkey], st, h, tp=mtp)
        cachelib.write_state(cache[r.key], new, keep)
        return y
    return layout.rows(layer_spec(cfg, pos), run, h, keep, clen, act)


def block_train(cfg: ArchConfig, pos: int, p, x, rope, *, alpha=None, tp=None):
    """The training forward of one block, differentiable. x: (B, S, d).
    Attention is full causal, or the layer's window (a ``local_global``
    window layer); with ``alpha`` ((Hkv,), head identification) the α-gated
    mix of ``core/gating.py`` instead, window layers too, as the reference
    does. A recurrent layer runs its mixer's forward from a fresh state."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mixer = cfg.mixer_for_layer(pos)
    if mixer != MIXER_ATTENTION:
        r = _RECURRENT[mixer]
        return _ffn_apply(cfg, pos, p, x + r.forward(cfg, p[r.pkey], h, tp=_mixer_tp(tp, r)),
                          tp)
    q, k, v = _qkv(cfg, p, h, tp)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if alpha is not None:
        o = gatinglib.gated_attention(q, k, v, alpha, sink=cfg.h2eal.sink,
                                      local=cfg.h2eal.local)
    else:
        o = kops.flash_attention(q, k, v, causal=True, window=attn_spec(cfg, pos).window)
    b, s = o.shape[:2]
    return _ffn_apply(cfg, pos, p, x + _out(p, o.reshape(b, s, -1), tp), tp)


def block_prefill(cfg: ArchConfig, pos: int, p, perm, x, rope, *, capacity: int,
                  layout=layoutlib.DEFAULT, tp=None):
    """One block over the prompt. x: (B, S, d) -> (x, the layer's cache): the
    whole batch's cache (a GSPMD layout cuts its block afterwards)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mixer = cfg.mixer_for_layer(pos)
    if mixer != MIXER_ATTENTION:
        y, cache = _recurrent_prefill(cfg, mixer, p, h, tp)
        return _ffn_apply(cfg, pos, p, x + y, tp), cache
    spec = attn_spec(cfg, pos)
    q, k, v = _qkv(cfg, p, h, tp)
    cos, sin = rope
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    b, s = q.shape[:2]
    o = hattn.prefill_attention(spec, q, k, v, perm)
    if not spec.full_cache:
        cache = layout.prefill(spec, k, v, s, capacity, perm)
    else:  # full-attention baseline / sliding-window layer
        full = cachelib.make_full_cache(b, cfg.num_kv_heads, capacity,
                                        spec.head_dim, dtype=k.dtype,
                                        device=k.device)
        full.k[:, :, :s] = k.transpose(1, 2)
        full.v[:, :, :s] = v.transpose(1, 2)
        cache = {"full": full}
    x = x + _out(p, o.reshape(b, s, -1), tp)
    return _ffn_apply(cfg, pos, p, x, tp), cache


def empty_block_cache(cfg: ArchConfig, pos: int, batch: int, capacity: int, *,
                      dtype, device, layout=layoutlib.DEFAULT):
    """The empty serve cache of ``batch`` slots of a block at period position
    ``pos`` (a GSPMD layout's: the rank's block of it)."""
    if layout.gspmd:
        whole = empty_block_cache(cfg, pos, batch, capacity, dtype=dtype, device="meta")
        return layout.block(layer_spec(cfg, pos), whole, device)
    mixer = cfg.mixer_for_layer(pos)
    if mixer != MIXER_ATTENTION:
        r = _RECURRENT[mixer]
        return {r.key: r.state_cls(**r.init_state(cfg, batch, dtype, device))}
    spec = attn_spec(cfg, pos)
    if not spec.full_cache:
        paged, stream = layout.empty_decode_state(spec, batch, capacity,
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
    caller ignores. A recurrent layer resumes each slot's state over its
    chunk (the state of a slot without tokens stays as it was)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mixer = cfg.mixer_for_layer(pos)
    if mixer != MIXER_ATTENTION:
        y = _recurrent_step(cfg, pos, p, h, cache, None, chunk=(chunk_len, active),
                            layout=layout)
        return _ffn_apply(cfg, pos, p, x + y), cache
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
        o, full = layout.full_chunk(spec, cache["full"], q, k, v, start, chunk_len,
                                    active)
        cache = {"full": full}
    x = x + _out(p, o.reshape(b, cch, -1))
    return _ffn_apply(cfg, pos, p, x), cache


def block_decode(cfg: ArchConfig, pos: int, p, perm, x, rope1, cache, *, length,
                 do_select: bool, layout=layoutlib.DEFAULT, active=None,
                 need_select=None, tp=None):
    """Decode one token through one block. x: (B, d). ``length`` is an int
    (lockstep) or (B,) tensor (continuous batching, with the per-slot
    ``active`` and ``need_select`` masks of ``decode_attention``). A
    recurrent layer steps the state of the ``active`` slots (all in
    lockstep)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mixer = cfg.mixer_for_layer(pos)
    if mixer != MIXER_ATTENTION:
        y = _recurrent_step(cfg, pos, p, h, cache, active, layout=layout, tp=tp)
        return _ffn_apply(cfg, pos, p, x + y, tp), cache
    spec = attn_spec(cfg, pos)
    q, k, v = _qkv(cfg, p, h, tp)
    cos1, sin1 = rope1  # (1 or B, 1, half) at each slot's position
    q = apply_rope(q[:, None], cos1, sin1)[:, 0]
    k = apply_rope(k[:, None], cos1, sin1)[:, 0]
    if "full" in cache:
        o, full = layout.full_decode(spec, cache["full"], q, k, v, length, active)
        cache = {"full": full}
    else:
        o, cache = layout.decode(spec, cache, q, k, v, length,
                                 do_select=do_select, perm=perm, active=active,
                                 need_select=need_select)
    x = x + _out(p, o.reshape(o.shape[0], -1), tp)
    return _ffn_apply(cfg, pos, p, x, tp), cache


def block_verify_chunk(cfg: ArchConfig, pos: int, p, perm, x, rope, cache, *, start,
                       active, need_select, layout=layoutlib.DEFAULT):
    """k drafted tokens through one block as k decode steps in one chunk,
    the block's KV caches unchanged (``layouts.dispatch_verify_chunk``: the
    selection and importance refresh only). x: (B, k, d); ``rope`` is (cos,
    sin) at positions start .. start+k-1. Returns (x, cache, (k_roped, v)):
    the chunk's KV, kept for ``block_verify_append`` to commit once the
    accepted length is known. The engine serves speculation on dense
    full-attention stacks only (not ``local_global`` nor a recurrent mixer,
    as the JAX engine), so there is no other mixer or window layer here."""
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
    x = x + _out(p, o.reshape(b, kch, -1))
    return _ffn_apply(cfg, pos, p, x), cache, (k, v)


def block_verify_append(cfg: ArchConfig, pos: int, perm, cache, kv, *, start,
                        accepted, active, layout=layoutlib.DEFAULT):
    """Commit the accepted prefix of a verified chunk into one block's
    caches from the (k_roped, v) of ``block_verify_chunk``."""
    k, v = kv
    return layoutlib.dispatch_verify_append(layout, attn_spec(cfg, pos), cache, k, v,
                                            start, accepted, active=active,
                                            perm=perm)

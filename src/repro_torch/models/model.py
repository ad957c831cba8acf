"""Model API: the training forward and ``lm_loss``; for serving, prefill,
prefill_chunk, decode_step and the speculative verify (verify_forward,
verify_commit).

Counterpart of ``repro/models/model.py``. The serve state is
``{"length": ..., "layers": [cache per layer]}``: an attention layer's KV
caches, or a recurrent layer's state (``models/transformer.py``). On the
lockstep path ``length`` is a Python int; in the continuous-batching engine's batched
state it is a (B,) int32 tensor on the state's device, advanced on the
device, so no step reads a value back from the card. The caches are
updated in place by ``prefill_chunk`` and ``decode_step``.

A frontend-stub arch (``cfg.embed_frontend_stub``: internvl2-1b,
musicgen-large) takes precomputed embeddings where another arch takes
token ids: ``forward``, ``lm_loss`` and ``prefill`` (B, S, d_model),
``decode_step`` (B, d_model). They are not cast, as in the reference: f32
embeddings over bf16 weights promote the whole stack, caches included, to
f32. Chunked prefill and the speculative verify feed token ids through the
embedding and refuse such an arch, as the reference does.

``forward``, ``lm_loss``, ``prefill`` and ``decode_step`` take ``tp``, a
``runtime/tensor_parallel.TensorParallel`` of the parameters where they
are cut over a mesh (lockstep ``generate(mesh=...)``, the sharded train
step); None is the whole-weight path.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN_LOCAL_GLOBAL, MIXER_ATTENTION, ArchConfig
from repro_torch.core import layouts as layoutlib
from repro_torch.core.paging import chunk_positions
from repro_torch.models import transformer as T
from repro_torch.models.layers import rms_norm, rope_cos_sin
from repro_torch.runtime import tensor_parallel as tplib


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device,
                dtype=torch.float32):
    return T.init_params(cfg, generator=generator, device=device, dtype=dtype)


STUB_CHUNK_REFUSAL = ("chunked prefill feeds token chunks through the embedding; "
                      "frontend-stub archs use prefill-then-pack admission")

# a frontend-stub arch (internvl2-1b, musicgen-large) takes precomputed
# embeddings, which a Request's token-id prompt cannot carry; the reference's
# engine constructs, then feeds the prompt's and the sampled token ids where
# embeddings are due and fails (ROADMAP Queue 3)
STUB_ENGINE_REFUSAL = (
    "frontend-stub archs take precomputed embeddings, not token ids: the "
    "reference's Engine.run and generate feed token ids where an embedding "
    "is due and fail; serve them through models.model.prefill and "
    "decode_step fed embeddings")


def embed_input(cfg: ArchConfig, params, batch, tp=None):
    """batch: (B, S) or (B,) int token ids; for a frontend-stub arch the
    (B, S, d_model) or (B, d_model) embeddings themselves, passed through.
    Over a mesh (``tp``) the vocabulary may be cut: each rank looks up the
    ids it owns and the rows are summed."""
    if cfg.embed_frontend_stub:
        return batch
    if tp is not None:
        return tplib.embed(tp, params, batch)
    return params["embed"][batch.long()]


def unembed(cfg: ArchConfig, params, x, tp=None):
    """The final norm and the vocabulary projection, in the promoted dtype of
    x and the weight, as the reference's einsum (head identification's
    gated mix gives f32 activations over bf16 weights). Over a vocabulary
    cut (``tp``) each rank computes its block of the logits and the blocks
    are gathered: every rank holds the whole logits."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if tp is not None:
        return tplib.logits(tp, params, x, cfg.tie_embeddings)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _rope(cfg: ArchConfig, positions):
    return rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


def layer_positions(cfg: ArchConfig):
    """Each layer's period position (remainder layers continue the pattern)."""
    period = T.period_len(cfg)
    return [i % period for i in range(cfg.num_layers)]




def _layer_tp(tp, i: int):
    return None if tp is None else tp.at("layers", i)


def forward(cfg: ArchConfig, params, batch, *, alpha=None, remat: bool = False,
            tp=None):
    """The full-sequence training forward: tokens (B, S) (a frontend stub's
    embeddings (B, S, d_model)) -> logits (B, S, V).

    ``alpha`` ((num_layers, Hkv)) gates each attention layer's heads for
    head identification (``core/gating.py``); None is plain attention.
    With ``remat`` each period of ``period_len(cfg)`` layers is recomputed
    in the backward (``torch.utils.checkpoint``, as ``jax.checkpoint`` of
    the reference's period); the remainder layers are not, as there. A
    period recomputed in the backward repeats its collectives there, in the
    same order on every rank."""
    T.check_ported(cfg)
    x = embed_input(cfg, params, batch, tp)
    rope = _rope(cfg, torch.arange(x.shape[1], device=x.device))
    period = T.period_len(cfg)
    n_per = cfg.num_layers // period

    def run(x, first: int, count: int):
        for i in range(first, first + count):
            x = T.block_train(cfg, i % period, params["layers"][i], x, rope,
                              alpha=None if alpha is None else alpha[i],
                              tp=_layer_tp(tp, i))
        return x

    for per in range(n_per):
        if remat:
            x = checkpoint(run, x, per * period, period, use_reentrant=False)
        else:
            x = run(x, per * period, period)
    x = run(x, n_per * period, cfg.num_layers - n_per * period)
    return unembed(cfg, params, x, tp)


def lm_loss(cfg: ArchConfig, params, batch, labels, *, alpha=None,
            remat: bool = True, tp=None, count=None):
    """Mean next-token cross-entropy over the labels >= 0 (-100 pads), from
    the f32 log-softmax of the logits. ``count`` divides the sum in place of
    this batch's own count of labels (the sharded step passes the global
    batch's, so that the ranks' losses sum to its mean).

    Over a vocabulary cut (``tp``) the logits are gathered whole before the
    log-softmax (``unembed``), not reduced in a distributed log-softmax:
    each rank receives (M-1)/M of B·S·V f32 logits of its rows (M ranks on
    'model'), 2.1 GB a rank at llama3-8b's V = 128256 for 2 x 2048 tokens,
    and its backward sends nothing more (the gather's backward is the
    rank's slice)."""
    logits = forward(cfg, params, batch, alpha=alpha, remat=remat, tp=tp).float()
    mask = labels >= 0
    lab = torch.clamp(labels, min=0).long()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, lab[..., None])[..., 0]
    return (nll * mask).sum() / (torch.clamp(mask.sum(), min=1) if count is None else count)


def prefill(cfg: ArchConfig, params, batch, *, capacity: int, plan=None,
            layout=layoutlib.DEFAULT, tp=None):
    """Process the prompt (B, S) (a frontend stub's embeddings (B, S,
    d_model)); returns (last-token logits (B, V), state).
    ``layout`` (a ``core/layouts`` layout) builds the caches in its page
    order, as it does in every step below; the caches are the whole
    batch's (lockstep ``generate`` on a mesh cuts each rank's block of them,
    ``runtime/serve.make_prefill``)."""
    T.check_ported(cfg, layout)
    plan = plan if plan is not None else T.default_plan(cfg)
    x = embed_input(cfg, params, batch, tp)
    s = x.shape[1]
    rope = _rope(cfg, torch.arange(s, device=x.device))
    caches = []
    for i, (pos, p, perm) in enumerate(zip(layer_positions(cfg), params["layers"], plan)):
        x, c = T.block_prefill(cfg, pos, p, perm, x, rope, capacity=capacity,
                               layout=layout, tp=_layer_tp(tp, i))
        caches.append(c)
    return unembed(cfg, params, x[:, -1], tp), {"length": s, "layers": caches}


def empty_serve_state(cfg: ArchConfig, batch: int, *, capacity: int, dtype,
                      device, layout=layoutlib.DEFAULT):
    """The batched serve state of ``batch`` free slots: (B,) lengths 0 and
    empty caches (a slot's rows are rewritten at admission). Under a GSPMD
    layout (placed on a rank) the caches are the rank's blocks; the lengths
    stay whole, as the reference replicates them."""
    T.check_ported(cfg, layout)
    layers = [T.empty_block_cache(cfg, pos, batch, capacity, dtype=dtype,
                                  device=device, layout=layout)
              for pos in layer_positions(cfg)]
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
    if cfg.embed_frontend_stub:
        raise ValueError(STUB_CHUNK_REFUSAL)
    plan = plan if plan is not None else T.default_plan(cfg)
    start = state["length"]
    x = embed_input(cfg, params, tokens)
    b, cch = tokens.shape
    rope = _rope(cfg, chunk_positions(start, cch))  # (B, C, half)
    caches = []
    for pos, p, perm, c in zip(layer_positions(cfg), params["layers"], plan,
                               state["layers"]):
        x, c = T.block_prefill_chunk(cfg, pos, p, perm, x, rope, c, start=start,
                                     chunk_len=chunk_len, active=active,
                                     layout=layout)
        caches.append(c)
    new_len = torch.where(active, start + chunk_len, start).to(start.dtype)
    last = (chunk_len.long() - 1).clamp(0, cch - 1)
    x_last = x[torch.arange(b, device=x.device), last]
    return unembed(cfg, params, x_last), {"length": new_len, "layers": caches}


def verify_forward(cfg: ArchConfig, params, state, tokens, *, active,
                   need_select, plan=None, layout=layoutlib.DEFAULT):
    """Speculative verify: k drafted tokens a slot as k decode steps in ONE
    chunked pass over the pre-append caches (attend-before-append).

    tokens: (B, k) int, column 0 each slot's pending feed token, columns
    1..k-1 the draft, at positions length .. length+k-1. Returns (logits
    (B, k, V), state, stash): logits row j is the distribution at position
    length+j; ``state`` differs from the input only in the selection and
    importance (refreshed for ``need_select & active``), the pages, rings
    and lengths untouched; ``stash`` holds each layer's roped chunk (k, v)
    for ``verify_commit``. The accepted length decides how much of the
    chunk is committed; nothing is ever rolled back. Not for a
    ``local_global`` stack, whose window layers have no verify chunk, nor
    for a recurrent mixer, whose state a verify chunk would advance, nor
    for a frontend stub, which has no embedding to feed drafted ids through
    (the JAX engine refuses ``spec_tokens`` there too)."""
    if cfg.attn_pattern == ATTN_LOCAL_GLOBAL:
        raise ValueError("verify_forward requires the full attention pattern "
                         "(local_global windows have no verify-chunk path)")
    if any(m != MIXER_ATTENTION for m in cfg.mixer_pattern):
        raise ValueError("verify_forward requires all-attention mixers; "
                         f"mixer_pattern={cfg.mixer_pattern}")
    if cfg.embed_frontend_stub:
        raise ValueError("spec_tokens feeds token chunks through the embedding; "
                         "frontend-stub archs are unsupported")
    plan = plan if plan is not None else T.default_plan(cfg)
    start = state["length"]
    x = embed_input(cfg, params, tokens)
    rope = _rope(cfg, chunk_positions(start, tokens.shape[1]))  # (B, k, half)
    caches, stash = [], []
    for pos, p, perm, c in zip(layer_positions(cfg), params["layers"], plan,
                               state["layers"]):
        x, c, kv = T.block_verify_chunk(cfg, pos, p, perm, x, rope, c, start=start,
                                        active=active, need_select=need_select,
                                        layout=layout)
        caches.append(c)
        stash.append(kv)
    return unembed(cfg, params, x), {"length": start, "layers": caches}, stash


def verify_commit(cfg: ArchConfig, state, stash, *, accepted, active, plan=None,
                  layout=layoutlib.DEFAULT):
    """Commit each slot's accepted prefix (``accepted`` (B,), at least one
    token of the verified chunk) from the ``verify_forward`` stash, through
    the chunk appends that the same tokens decoded one at a time reduce to;
    inactive slots commit nothing. Returns the state advanced by the
    accepted lengths."""
    plan = plan if plan is not None else T.default_plan(cfg)
    start = state["length"]
    caches = [T.block_verify_append(cfg, pos, perm, c, kv, start=start,
                                    accepted=accepted, active=active, layout=layout)
              for pos, perm, c, kv in zip(layer_positions(cfg), plan, state["layers"],
                                          stash)]
    new_len = torch.where(active, start + accepted, start).to(start.dtype)
    return {"length": new_len, "layers": caches}


def decode_step(cfg: ArchConfig, params, state, token, *, plan=None,
                do_select: bool = True, layout=layoutlib.DEFAULT, active=None,
                need_select=None, tp=None):
    """One decode step. token: (B,) int (a frontend stub's embeddings (B,
    d_model)). Returns (logits (B, V), state advanced by one token).

    ``state["length"]`` is an int (lockstep) or a (B,) tensor (continuous
    batching), where ``active`` (B,) bool marks the decoding slots (the
    others neither append nor advance; their logits are ignored) and
    ``need_select`` (B,) bool, on a select step, the slots whose share
    window has run out.
    """
    plan = plan if plan is not None else T.default_plan(cfg)
    length = state["length"]
    x = embed_input(cfg, params, token, tp)
    if isinstance(length, torch.Tensor):
        cos, sin = _rope(cfg, length)                # (B, half), on the card
    else:
        # arange, not torch.tensor([length]): a host-to-card copy would
        # synchronise the stream every step
        cos, sin = _rope(cfg, torch.arange(length, length + 1, device=x.device))
    rope1 = (cos[:, None], sin[:, None])  # (1 or B, 1, half)
    caches = []
    for i, (pos, p, perm, c) in enumerate(zip(layer_positions(cfg), params["layers"],
                                              plan, state["layers"])):
        x, c = T.block_decode(cfg, pos, p, perm, x, rope1, c, length=length,
                              do_select=do_select, layout=layout,
                              active=active, need_select=need_select,
                              tp=_layer_tp(tp, i))
        caches.append(c)
    new_len = length + 1
    if active is not None:
        new_len = torch.where(active, new_len, length).to(length.dtype)
    return unembed(cfg, params, x, tp), {"length": new_len, "layers": caches}

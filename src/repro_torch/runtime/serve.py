"""Serving step builders (counterpart of ``repro/runtime/serve.py``).

The decode step comes in two variants, select and reuse: the serving
loop calls the select variant every ``share_window`` steps (fresh page
scoring and top-k) and the cheaper reuse variant in between. The
continuous-batching engine uses the ragged decode steps, the greedy
sampler, the chunked-prefill step and the fused decode window.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import layouts as layoutlib
from repro_torch.models import model as M


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device; no silent CPU run."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    capacity: int             # most context tokens the cache holds
    layout: str = "default"   # core/layouts name: "default" or "coplace_shmap"
    shards: int = 1           # coplace_shmap's page stripes


def _layout(scfg: ServeConfig):
    return layoutlib.get_layout(scfg.layout, scfg.shards)


def make_prefill(cfg: ArchConfig, scfg: ServeConfig):
    layout = _layout(scfg)

    def prefill(params, batch):
        return M.prefill(cfg, params, batch, capacity=scfg.capacity,
                         layout=layout)
    return prefill


def make_decode_step(cfg: ArchConfig, scfg: ServeConfig, *, do_select: bool):
    layout = _layout(scfg)

    def decode(params, state, token):
        return M.decode_step(cfg, params, state, token, do_select=do_select,
                             layout=layout)
    return decode


def make_ragged_decode_step(cfg: ArchConfig, scfg: ServeConfig, *,
                            do_select: bool):
    """Decode step of the continuous-batching engine: per-slot (B,) lengths
    in the state and an ``active`` mask; the select variant also takes
    ``need_select``, each slot's share-window phase."""
    layout = _layout(scfg)
    if do_select:
        def decode(params, state, token, active, need_select):
            return M.decode_step(cfg, params, state, token, do_select=True,
                                 layout=layout, active=active,
                                 need_select=need_select)
    else:
        def decode(params, state, token, active):
            return M.decode_step(cfg, params, state, token, do_select=False,
                                 layout=layout, active=active)
    return decode


def make_sample_step(cfg: ArchConfig, scfg: ServeConfig):
    """The greedy lane of the engine's sampler: (logits (B, V)) -> tokens
    (B,) int32, the first maximal index (as ``argmax`` on both sides).
    Stochastic sampling is ROADMAP Queue 1 item 6."""
    del cfg, scfg  # greedy sampling depends on neither

    def sample(logits):
        return logits.argmax(dim=-1).to(torch.int32)
    return sample


def make_prefill_chunk_step(cfg: ArchConfig, scfg: ServeConfig, *, chunk: int):
    """Chunked-prefill half of the engine's mixed step: each prefilling
    slot's next prompt chunk (at most ``chunk`` tokens, a fixed shape) goes
    straight into its rows of the batched state."""
    layout = _layout(scfg)

    def chunk_step(params, state, tokens, chunk_len, active):
        if tokens.shape[1] != chunk:
            raise ValueError(f"chunk of {tokens.shape[1]} tokens, expected {chunk}")
        return M.prefill_chunk(cfg, params, state, tokens, chunk_len=chunk_len,
                               active=active, layout=layout)
    return chunk_step


def make_fused_window_step(cfg: ArchConfig, scfg: ServeConfig, *, window: int,
                           chunk: Optional[int] = None):
    """Fused decode window: ``window`` reuse steps as one dispatch.

    A loop over the reuse-step body (``layouts.dispatch_decode_window``,
    the counterpart of the reference's ``lax.scan``) with the greedy sample
    folded in and retirement on the card: slot i emits exactly
    ``budgets[i]`` tokens (``sched/windows.window_budgets``), then its lane
    of the carried ``active`` mask flips and the remaining iterations leave
    its rows as they are, bit for bit, as the per-step loop does for an
    inactive slot. The engine captures the whole window as one CUDA graph.

    Decode-only variant (``chunk=None``)::

        fused(params, state, tok, active, budgets)
          -> (trace (window, B) int32, state', tok')

    Mixed variant (``chunk=C``) also feeds the engine's presimulated
    chunked-prefill schedule, per iteration a (B, C) token block and the
    per-slot chunk lengths, applied BEFORE the decode half as in the
    per-step mixed step, and a ``finish`` mask marking the rows whose
    prompt completes at that iteration (their first token is the greedy
    sample of the chunk logits, as ``Engine._first_token`` takes it)::

        fused(params, state, tok, active, budgets,
              chunk_tokens (window, B, C), chunk_lens (window, B),
              finish (window, B)) -> (trace, state', tok')

    Rows of ``trace`` past a slot's budget hold its last token (the
    ``where`` carry), never fresh samples. Iterations past the useful
    length are full no-ops (all-inactive masks), so one capture serves
    every boundary residue. The sampling lanes (temperature, top-p,
    per-request seeds) come with Queue 1 item 6.
    """
    layout = _layout(scfg)
    sample = make_sample_step(cfg, scfg)

    def decode_half(params, state, tok, act, emitted, budgets):
        logits, state = M.decode_step(cfg, params, state, tok, do_select=False,
                                      layout=layout, active=act)
        tok = torch.where(act, sample(logits), tok)
        emitted = emitted + act.to(emitted.dtype)
        act = act & (emitted < budgets)
        return state, tok, act, emitted

    if chunk is None:
        def fused(params, state, tok, active, budgets):
            def body(carry, _):
                state, tok, act, emitted = decode_half(params, *carry, budgets)
                return (state, tok, act, emitted), tok

            carry0 = (state, tok, active, torch.zeros_like(budgets))
            (state, tok, _, _), trace = layoutlib.dispatch_decode_window(
                layout, body, carry0, None, length=window)
            return trace, state, tok
    else:
        def fused(params, state, tok, active, budgets, chunk_tokens, chunk_lens,
                  finish):
            if tuple(chunk_tokens.shape[::2]) != (window, chunk):
                raise ValueError(f"chunk tokens of shape {tuple(chunk_tokens.shape)}, "
                                 f"expected ({window}, B, {chunk})")

            def body(carry, xs):
                state, tok, act, emitted = carry
                ctoks, clens, fin = xs
                logits_c, state = M.prefill_chunk(cfg, params, state, ctoks,
                                                  chunk_len=clens, active=clens > 0,
                                                  layout=layout)
                tok = torch.where(fin, sample(logits_c), tok)
                state, tok, act, emitted = decode_half(params, state, tok, act,
                                                       emitted, budgets)
                return (state, tok, act, emitted), tok

            carry0 = (state, tok, active, torch.zeros_like(budgets))
            (state, tok, _, _), trace = layoutlib.dispatch_decode_window(
                layout, body, carry0, (chunk_tokens, chunk_lens, finish),
                length=window)
            return trace, state, tok
    return fused

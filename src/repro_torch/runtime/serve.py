"""Serving step builders (counterpart of ``repro/runtime/serve.py``).

The decode step comes in two variants, select and reuse: the serving
loop calls the select variant every ``share_window`` steps (fresh page
scoring and top-k) and the cheaper reuse variant in between. The
continuous-batching engine uses the ragged decode steps, the per-slot
sampler, the chunked-prefill step, the fused decode window and the
speculative verify step.

Lockstep generation on a mesh (the reference's ``jit_serve_steps``) runs
``make_lockstep_prefill`` and ``make_decode_step`` on the rank's parameter
blocks (``tp``, cut by ``param_shardings(mode="serve")``) and the rank's
blocks of the serve state, placed by the layout for the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import layouts as layoutlib
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.serving import sampling


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
    layout: str = "default"   # a core/layouts registry name
    shards: int = 1           # coplace_shmap's page stripes
    mesh: Any = None          # the ranks' mesh (launch/mesh.Mesh) of a GSPMD
                              # layout, or of coplace_shmap over ranks
    max_batch: int = 0        # the batched state's slots (a GSPMD layout's blocks)


def serve_layout(scfg: ServeConfig):
    """The layout of ``scfg``; a GSPMD layout (or coplace_shmap, or default,
    given a mesh: ``layouts.mesh_layout``) placed on this rank of its mesh
    for ``max_batch`` slots. The engine gives a mesh to the GSPMD layouts
    only."""
    lay = layoutlib.mesh_layout(scfg.layout, scfg.shards, scfg.mesh)
    if lay.gspmd:
        if scfg.mesh is None or scfg.max_batch < 1:
            raise ValueError(f"layout {lay.name!r} serves the engine's batched state: "
                             f"give the ServeConfig its plan's mesh and max_batch")
        return lay.placed(scfg.mesh, batch=scfg.max_batch, capacity=scfg.capacity)
    return lay


def make_prefill(cfg: ArchConfig, scfg: ServeConfig):
    """prefill(params, batch): batch (B, S) token ids, or a frontend stub's
    (B, S, d_model) embeddings (``make_decode_step``'s token likewise (B,)
    or (B, d_model))."""
    layout = serve_layout(scfg)

    def prefill(params, batch):
        return M.prefill(cfg, params, batch, capacity=scfg.capacity,
                         layout=layout)
    return prefill


def make_lockstep_prefill(cfg: ArchConfig, scfg: ServeConfig, tp):
    """prefill(params, batch) of lockstep generation on ``scfg.mesh`` for a
    batch of ``scfg.max_batch``: the whole batch's prefill on the rank's
    parameter blocks (``tp``), then each layer's cache cut into the rank's
    block (``PlacedLayout.cut``, as the engine's packed prefill packs the
    rank's block of a row) and the length made (B,): the engine's batched
    state with every row active at one length, which ``make_decode_step``
    steps."""
    layout = serve_layout(scfg)
    if not layout.gspmd:
        raise ValueError("make_lockstep_prefill places the state on a mesh: give the "
                         "ServeConfig its mesh")

    def prefill(params, batch):
        logits, state = M.prefill(cfg, params, batch, capacity=scfg.capacity,
                                  layout=layout, tp=tp)
        layers = [layout.cut(T.layer_spec(cfg, pos), c)
                  for pos, c in zip(M.layer_positions(cfg), state["layers"])]
        length = torch.full((batch.shape[0],), state["length"], dtype=torch.int32,
                            device=logits.device)
        return logits, {"length": length, "layers": layers}
    return prefill


def make_decode_step(cfg: ArchConfig, scfg: ServeConfig, *, do_select: bool, tp=None):
    """decode(params, state, token) of lockstep generation; on a mesh the
    rank's parameter blocks (``tp``) and state blocks
    (``make_lockstep_prefill``)."""
    layout = serve_layout(scfg)

    def decode(params, state, token):
        return M.decode_step(cfg, params, state, token, do_select=do_select,
                             layout=layout, tp=tp)
    return decode


def make_ragged_decode_step(cfg: ArchConfig, scfg: ServeConfig, *,
                            do_select: bool):
    """Decode step of the continuous-batching engine: per-slot (B,) lengths
    in the state and an ``active`` mask; the select variant also takes
    ``need_select``, each slot's share-window phase."""
    layout = serve_layout(scfg)
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
    """The engine's batched per-slot sampler: (logits (B, V), base (B, 2)
    int64 keys, gen (B,) int32, temp / topp (B,) f32, active (B,) bool) ->
    (tokens (B,) int32, gen'). Greedy is the temp == 0 lane of the same
    sampler; each token's key is derived on the card from the request's
    base key and its generation index (``serving/sampling.py``), and gen
    advances on the active lanes only."""
    del cfg, scfg  # sampling depends on neither the model nor the layout

    def sample(logits, base, gen, temp, topp, active):
        tok = sampling.sample_tokens(logits, base, gen, temp, topp)
        return tok, torch.where(active, gen + 1, gen)
    return sample


def make_verify_step(cfg: ArchConfig, scfg: ServeConfig, *, k: int):
    """The speculative verify step at the fixed (B, k) shape.

    tokens (B, k) int32: column 0 each slot's pending feed token, columns
    1..k-1 the draft. The verify forward over the pre-append caches
    (``models/model.verify_forward``), the coupled targets (each chunk
    position drawn with the key the non-speculative sampler would use,
    ``sampling.sample_chunk``), the acceptance rule and the commit of the
    accepted prefix (``verify_commit``).

    Draft j is accepted iff it equals the target drawn at position j - 1
    with that position's key; at the first mismatch the target is emitted.
    For a point-mass draft that is rejection sampling (P(accept) = p(d)),
    and the trace is the non-speculative one sample for sample; at
    temperature 0 it is "accept while the draft is the argmax".
    ``max_emit`` (B,) is the host's clamp (share-window boundary, budget,
    capacity): no selection refresh falls inside a chunk. Returns (targets
    (B, k), accepted (B,), next_tok (B,), gen', state')::

        verify(params, state, tokens, active, need_select, base, gen, temp,
               topp, max_emit)
    """
    layout = serve_layout(scfg)

    def verify(params, state, tokens, active, need_select, base, gen, temp, topp,
               max_emit):
        if tokens.shape[1] != k:
            raise ValueError(f"verify chunk of {tokens.shape[1]} tokens, expected {k}")
        logits, state1, stash = M.verify_forward(cfg, params, state, tokens,
                                                 active=active,
                                                 need_select=need_select,
                                                 layout=layout)
        targets = sampling.sample_chunk(logits, base, gen, temp, topp)
        matches = (tokens[:, 1:] == targets[:, :-1]).to(torch.int32)  # (B, k-1)
        n_nat = 1 + torch.cumprod(matches, dim=1).sum(dim=1)
        n = torch.minimum(n_nat, torch.clamp(max_emit, min=1)).to(torch.int32)
        state2 = M.verify_commit(cfg, state1, stash, accepted=n, active=active,
                                 layout=layout)
        next_tok = targets.gather(1, (n - 1).long()[:, None])[:, 0]
        new_gen = torch.where(active, gen + n, gen)
        return targets, n, next_tok, new_gen, state2
    return verify


def make_prefill_chunk_step(cfg: ArchConfig, scfg: ServeConfig, *, chunk: int):
    """Chunked-prefill half of the engine's mixed step: each prefilling
    slot's next prompt chunk (at most ``chunk`` tokens, a fixed shape) goes
    straight into its rows of the batched state."""
    layout = serve_layout(scfg)

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
    the counterpart of the reference's ``lax.scan``) with the sampler
    folded in and retirement on the card: slot i emits exactly
    ``budgets[i]`` tokens (``sched/windows.window_budgets``), then its lane
    of the carried ``active`` mask flips and the remaining iterations leave
    its rows as they are, bit for bit, as the per-step loop does for an
    inactive slot. The engine captures the whole window as one CUDA graph.

    Decode-only variant (``chunk=None``)::

        fused(params, state, tok, active, gen, budgets, base, temp, topp)
          -> (trace (window, B) int32, state', tok', gen')

    Mixed variant (``chunk=C``) also feeds the engine's presimulated
    chunked-prefill schedule, per iteration a (B, C) token block and the
    per-slot chunk lengths, applied BEFORE the decode half as in the
    per-step mixed step, and a ``finish`` mask marking the rows whose
    prompt completes at that iteration (their first token is sampled from
    the chunk logits with gen = 0, as ``Engine._first_token`` samples it,
    and their gen set to 1)::

        fused(params, state, tok, active, gen, budgets, base, temp, topp,
              chunk_tokens (window, B, C), chunk_lens (window, B),
              finish (window, B)) -> (trace, state', tok', gen')

    Rows of ``trace`` past a slot's budget hold its last token (the
    ``where`` carry), never fresh samples. Iterations past the useful
    length are full no-ops (all-inactive masks), so one capture serves
    every boundary residue.
    """
    layout = serve_layout(scfg)

    def decode_half(params, state, tok, act, gen, emitted, budgets, base, temp,
                    topp):
        logits, state = M.decode_step(cfg, params, state, tok, do_select=False,
                                      layout=layout, active=act)
        t = sampling.sample_tokens(logits, base, gen, temp, topp)
        tok = torch.where(act, t, tok)
        gen = torch.where(act, gen + 1, gen)
        emitted = emitted + act.to(emitted.dtype)
        act = act & (emitted < budgets)
        return state, tok, act, gen, emitted

    if chunk is None:
        def fused(params, state, tok, active, gen, budgets, base, temp, topp):
            def body(carry, _):
                carry = decode_half(params, *carry, budgets, base, temp, topp)
                return carry, carry[1]

            carry0 = (state, tok, active, gen, torch.zeros_like(budgets))
            (state, tok, _, gen, _), trace = layoutlib.dispatch_decode_window(
                layout, body, carry0, None, length=window)
            return trace, state, tok, gen
    else:
        def fused(params, state, tok, active, gen, budgets, base, temp, topp,
                  chunk_tokens, chunk_lens, finish):
            if tuple(chunk_tokens.shape[::2]) != (window, chunk):
                raise ValueError(f"chunk tokens of shape {tuple(chunk_tokens.shape)}, "
                                 f"expected ({window}, B, {chunk})")

            def body(carry, xs):
                state, tok, act, gen, emitted = carry
                ctoks, clens, fin = xs
                logits_c, state = M.prefill_chunk(cfg, params, state, ctoks,
                                                  chunk_len=clens, active=clens > 0,
                                                  layout=layout)
                first = sampling.sample_tokens(logits_c, base, torch.zeros_like(gen),
                                               temp, topp)
                tok = torch.where(fin, first, tok)
                gen = torch.where(fin, torch.ones_like(gen), gen)
                carry = decode_half(params, state, tok, act, gen, emitted, budgets,
                                    base, temp, topp)
                return carry, carry[1]

            carry0 = (state, tok, active, gen, torch.zeros_like(budgets))
            (state, tok, _, gen, _), trace = layoutlib.dispatch_decode_window(
                layout, body, carry0, (chunk_tokens, chunk_lens, finish),
                length=window)
            return trace, state, tok, gen
    return fused

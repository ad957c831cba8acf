"""Draft providers of self-drafted speculative decoding (counterpart of
``repro/serving/draft.py``).

A ``DraftProvider`` proposes ``k - 1`` continuation tokens for each active
slot every verify step; the engine puts the slot's pending feed token in
front and verifies all ``k`` positions in one chunked forward
(``runtime/serve.make_verify_step``). The tokens never depend on the
draft: the coupled acceptance emits the non-speculative engine's tokens
for any proposal, so a provider trades acceptance against its own cost:

  * ``NgramDraft``: prompt lookup on the host (the longest recent suffix
    n-gram of the request's prompt and emitted tokens found earlier, and
    what followed it). No device work.
  * ``StreamingDraft``: the model drafts with its own streaming skeleton.
    k-1 greedy reuse steps on a copy of the serve state whose retrieval
    selection is the -1 sentinel, so the retrieval heads attend their sink
    and local pages only. The copy is a shadow state allocated once (under
    a GSPMD layout, the rank's block); the real state is never written.
  * ``ConstantDraft`` / ``ReplayDraft``: test doubles forcing all-reject
    (the one-token step) and all-accept (a replayed trace).

Providers that set ``needs_host_tokens`` get a host history per slot
(prompt and every emitted token) kept by the engine.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Sequence

import numpy as np
import torch


class DraftProvider:
    """Proposes (B, k-1) draft tokens for the active slots: ``draft``
    returns a numpy array, or a (B, k-1) int32 tensor on the engine's
    device; rows of inactive slots are ignored. ``needs_host_tokens`` asks
    the engine to keep ``engine._spec_history[slot]`` (prompt and emitted
    tokens, the pending feed token last). ``bind`` is called once, at the
    engine's construction."""

    name = "base"
    needs_host_tokens = False

    def bind(self, engine) -> None:
        del engine  # a host provider keeps nothing of the engine

    def draft(self, engine, active: np.ndarray, k: int):
        raise NotImplementedError

    def jit_cache_sizes(self) -> Dict[str, int]:
        """Captures of the steps the provider owns (merged into
        ``Engine.jit_cache_sizes``)."""
        return {}


class NgramDraft(DraftProvider):
    """Prompt-lookup drafting: match the longest recent suffix n-gram (n =
    max_n .. 1) of the slot's history against an earlier occurrence and
    propose what followed it; pad with the last proposed (or feed) token.
    Host work only, deterministic."""

    name = "ngram"
    needs_host_tokens = True

    def __init__(self, max_n: int = 3):
        self.max_n = max(int(max_n), 1)

    def _lookup(self, hist: Sequence[int], m: int) -> List[int]:
        hist = list(hist)
        cont: List[int] = []
        for n in range(min(self.max_n, len(hist) - 1), 0, -1):
            suffix = hist[-n:]
            for i in range(len(hist) - n - 1, -1, -1):  # the latest earlier one
                if hist[i:i + n] == suffix:
                    cont = hist[i + n:i + n + m]
                    break
            if cont:
                break
        pad = cont[-1] if cont else hist[-1]
        cont += [pad] * (m - len(cont))
        return cont[:m]

    def draft(self, engine, active: np.ndarray, k: int):
        out = np.zeros((engine.batch.max_batch, max(k - 1, 0)), np.int32)
        if k <= 1:
            return out
        for slot in np.nonzero(active)[0]:
            out[slot] = self._lookup(engine._spec_history[int(slot)], k - 1)
        return out


class StreamingDraft(DraftProvider):
    """Self-draft with the model's streaming heads: k-1 greedy reuse decode
    steps on a shadow of the serve state whose retrieval selection is the
    -1 sentinel, so the retrieval heads attend sink and local pages only
    (a sentinel slot is invalid in ``paging.token_validity``): the model
    restricted to its streaming skeleton.

    The shadow is allocated once, at ``bind`` (as large as the serve
    state's caches), and two steps run on it: ``mask`` copies the real
    state into it and sets the selection to -1; ``decode`` runs the k-1
    steps and writes the draft into a buffer the engine's verify step
    reads. On the card both are CUDA graphs captured at ``bind`` (after a
    warm-up with every lane off, a no-op), replayed from then on. The real
    state is only read."""

    name = "streaming"

    def __init__(self):
        self._graphs = None

    def bind(self, engine) -> None:
        if self._graphs is not None:
            raise ValueError("a StreamingDraft serves one engine (its captured "
                             "steps read that engine's buffers); build a fresh one")
        from repro_torch.core import layouts as layoutlib
        from repro_torch.models import model as M
        from repro_torch.runtime import graphs
        from repro_torch.runtime import serve as serve_rt

        k = engine.spec_tokens
        real = engine.batch.serve
        # under a GSPMD layout the shadow is the rank's block, as the state is
        shadow = M.empty_serve_state(engine.cfg, engine.batch.max_batch,
                                     capacity=engine.cache_capacity,
                                     dtype=engine.params["final_norm"].dtype,
                                     device=engine.device,
                                     layout=engine._placed or layoutlib.DEFAULT)
        dec = serve_rt.make_ragged_decode_step(engine.cfg, engine.serve_config,
                                               do_select=False)
        pairs = list(zip(graphs.snapshot(real), graphs.snapshot(shadow)))
        sel = [t for h, key, t in graphs.snapshot(shadow) if key == "sel_idx"]
        out = engine._draft_buf
        act = engine._act
        tok = engine._tok
        me = weakref.proxy(engine)

        def mask():
            for (_, _, src), (_, _, dst) in pairs:
                dst.copy_(src)
            for s in sel:
                s.fill_(-1)

        def decode():
            before = graphs.snapshot(shadow)
            state, t, cols = shadow, tok.clone(), []
            for _ in range(k - 1):
                logits, state = dec(me.params, state, t, act)
                t = torch.where(act, logits.argmax(dim=-1).to(torch.int32), t)
                cols.append(t)
            if cols:
                out.copy_(torch.stack(cols, dim=1))
            # the shadow's rebound fields go back into its own buffers, so
            # the next mask step finds them
            graphs.commit(before, state)

        self._graphs = graphs.StepGraphs(engine.device, eager=not engine._graphs.capture,
                                         mesh=engine.mesh)
        self._graphs.add("mask", mask)
        self._graphs.add("decode", decode)

    def draft(self, engine, active: np.ndarray, k: int):
        if k <= 1:
            return None
        self._graphs.run("mask")
        self._graphs.run("decode")
        return engine._draft_buf

    def jit_cache_sizes(self) -> Dict[str, int]:
        return {} if self._graphs is None else dict(self._graphs.captures)


class ConstantDraft(DraftProvider):
    """Test double: a constant (by default invalid) draft token. Every
    position rejects, so each verify step emits the one coupled target: the
    trajectory of the one-token step."""

    name = "constant"

    def __init__(self, token: int = -1):
        self.token = int(token)

    def draft(self, engine, active: np.ndarray, k: int):
        return np.full((engine.batch.max_batch, max(k - 1, 0)), self.token,
                       np.int32)


class ReplayDraft(DraftProvider):
    """Test double: replay a known continuation per uid (the trace of a
    non-speculative run, say). Under greedy every draft position matches
    its target: the all-accept path up to the engine's ``max_emit``
    clamps."""

    name = "replay"

    def __init__(self, oracle: Dict[int, Sequence[int]]):
        self.oracle = {int(u): [int(t) for t in toks] for u, toks in oracle.items()}

    def draft(self, engine, active: np.ndarray, k: int):
        b = engine.batch
        out = np.full((b.max_batch, max(k - 1, 0)), -1, np.int32)
        if k <= 1:
            return out
        for slot in np.nonzero(active)[0]:
            toks = self.oracle.get(int(b.uid[slot]))
            if toks is None:
                continue
            # the tokens emitted so far (the prefill's too) index the oracle:
            # the feed token is oracle[emitted - 1], the draft continues there
            emitted = int(engine._spec_emitted[slot])
            cont = toks[emitted:emitted + k - 1]
            out[slot, :len(cont)] = cont
        return out


_BUILTINS = {"ngram": NgramDraft, "streaming": StreamingDraft}


def resolve_draft(spec) -> DraftProvider:
    """``Engine(draft=...)``: a provider passes through; a name builds the
    builtin (``ngram`` or ``streaming``)."""
    if isinstance(spec, DraftProvider):
        return spec
    if isinstance(spec, str) and spec in _BUILTINS:
        return _BUILTINS[spec]()
    raise ValueError(f"unknown draft provider {spec!r}; builtins: "
                     f"{sorted(_BUILTINS)} (or pass a DraftProvider instance)")

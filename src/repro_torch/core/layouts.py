"""Serve-cache layouts (counterpart of ``repro/core/layouts.py``).

Two layouts are ported:

  * ``default``: the single-program §IV-A algorithm, the token-exactness
    oracle every other layout is held to;
  * ``coplace_shmap``: memory-compute co-placement (paper §IV-B) on one
    card. The JAX layout stripes the physical pages round-robin over the
    mesh's 'model' axis and runs one shard_map program per device; here
    that axis is a stripe axis of one tensor, of ``shards`` stripes (what
    the size of the ambient mesh's 'model' axis is to the JAX layout; 1, as
    on one JAX device, by default), and decode is split-KV over the stripes
    (``hybrid_attention.decode_attention_coplace``).

``head``, ``coplace`` and ``interleave`` are GSPMD placements over more
than one device; they raise until their ROADMAP item lands.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import hybrid_attention as hattn

LAYOUT_DEFAULT = "default"
LAYOUT_COPLACE_SHMAP = "coplace_shmap"
_NOT_PORTED = ("head", "coplace", "interleave")


@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    """What the serving engine needs to know before the first step.

    capacity_quantum    the cache capacity (tokens) rounds up to a multiple
                        of this (a whole number of pages per stripe).
    balance_shards      the stripe count ``admission="balanced"`` scores
                        page loads against (1: FIFO).
    page_stripe_shards  the physical page striping factor (1: physical
                        page order is logical page order).
    """

    layout: str
    capacity_quantum: int = 1
    balance_shards: int = 1
    page_stripe_shards: int = 1

    def round_capacity(self, tokens: int) -> int:
        q = max(int(self.capacity_quantum), 1)
        return -(-int(tokens) // q) * q


class DefaultLayout:
    """Single-program path: no striping."""

    name = LAYOUT_DEFAULT
    shards = 1

    def plan(self, cfg) -> LayoutPlan:
        del cfg  # the default plan depends on no configuration
        return LayoutPlan(layout=self.name)

    def prefill(self, spec, k, v, length: int, capacity: int, perm=None) -> Dict:
        """Build the decode state {"paged", "stream"} from prefill K/V."""
        paged, stream = hattn.init_decode_state(spec, k, v, length, capacity,
                                                perm,
                                                interleave_shards=self.shards)
        return {"paged": paged, "stream": stream}

    def prefill_chunk(self, spec, state: Dict, q, k_new, v_new, start,
                      chunk_len, active, perm=None):
        """Chunked prefill: attend one prompt chunk per slot and append it
        into the slots' caches -> (out (B, C, Hq, D), state)."""
        out, paged, stream = hattn.chunk_prefill_attention(
            spec, q, k_new, v_new, state["paged"], state["stream"], start,
            chunk_len, active, perm=perm, phys_shards=self.shards)
        return out, {"paged": paged, "stream": stream}

    def decode(self, spec, state: Dict, q, k_new, v_new, length, *,
               do_select: bool, perm=None, active=None, need_select=None):
        """Decode step, lockstep (int ``length``) or ragged ((B,) lengths,
        ``active``, ``need_select``) -> (out (B, Hq, D), state)."""
        out, paged, stream = hattn.decode_attention(
            spec, q, k_new, v_new, state["paged"], state["stream"], length,
            do_select=do_select, perm=perm, active=active,
            need_select=need_select)
        return out, {"paged": paged, "stream": stream}

    # the co-placed decode turns a selected masked page into -1; the
    # default keeps it as fill. The verify chunk selects as the decode does
    minus_one_masked = False

    def verify_chunk(self, spec, state: Dict, q, k_new, v_new, start, *,
                     active=None, need_select=None, perm=None):
        """Attend k drafted tokens as k decode steps over the pre-append
        caches (no KV write; the selection and importance refresh only) ->
        (out (B, k, Hq, D), state). One body for every layout: its masks
        come from absolute positions and page starts, and the fixed page
        sections follow the layout's physical page order."""
        out, paged, stream = hattn.chunk_verify_attention(
            spec, q, k_new, v_new, state["paged"], state["stream"], start,
            active, need_select, perm=perm, phys_shards=self.shards,
            minus_one_masked=self.minus_one_masked)
        return out, {"paged": paged, "stream": stream}

    def verify_append(self, spec, state: Dict, k_new, v_new, start, accepted, *,
                      active=None, perm=None):
        """Commit the accepted prefix of a verified chunk (the chunk
        appends) -> state."""
        paged, stream = hattn.chunk_verify_append(
            spec, k_new, v_new, state["paged"], state["stream"], start, accepted,
            active, perm=perm, phys_shards=self.shards)
        return {"paged": paged, "stream": stream}

    def decode_window(self, body, carry, xs, *, length: int):
        """Run ``length`` reuse decode steps as one fused window, the
        counterpart of the reference's ``lax.scan``: ``body(carry, x) ->
        (carry, y)`` takes ``x``, the i-th slice of every tensor of ``xs``
        (a tensor, a tuple of tensors, or None), and the per-iteration
        ``y`` are stacked. Returns (carry, stacked ys). ``body``'s decode
        math routes through this layout's own hooks, so a plain loop is
        right for every layout; a layout overrides this only to change how
        the window iterates, never the step math."""
        ys = []
        for i in range(length):
            if xs is None:
                x = None
            elif isinstance(xs, torch.Tensor):
                x = xs[i]
            else:
                x = tuple(a[i] for a in xs)
            carry, y = body(carry, x)
            ys.append(y)
        return carry, torch.stack(ys)


class CoplaceShmapLayout(DefaultLayout):
    """Co-placement over ``shards`` page stripes: striped page order at
    prefill and on chunk appends, split-KV partial attention per stripe and
    a log-sum-exp combine in decode."""

    name = LAYOUT_COPLACE_SHMAP
    minus_one_masked = True

    def __init__(self, shards: int):
        self.shards = int(shards)

    def plan(self, cfg) -> LayoutPlan:
        return LayoutPlan(layout=self.name,
                          capacity_quantum=cfg.h2eal.page_size * self.shards,
                          balance_shards=self.shards,
                          page_stripe_shards=self.shards)

    def decode(self, spec, state: Dict, q, k_new, v_new, length, *,
               do_select: bool, perm=None, active=None, need_select=None):
        out, paged, stream = hattn.decode_attention_coplace(
            spec, q, k_new, v_new, state["paged"], state["stream"], length,
            do_select=do_select, shards=self.shards, perm=perm, active=active,
            need_select=need_select)
        return out, {"paged": paged, "stream": stream}


DEFAULT = DefaultLayout()


def dispatch_decode_window(layout, body, carry, xs, *, length: int):
    """Route a fused decode window (a loop over reuse-step bodies) to
    ``layout``'s ``decode_window`` hook."""
    return layout.decode_window(body, carry, xs, length=length)


def dispatch_verify_chunk(layout, spec, state: Dict, q, k_new, v_new, start, *,
                          active=None, need_select=None, perm=None):
    """Route one speculative verify pass to ``layout``'s verify_chunk hook."""
    return layout.verify_chunk(spec, state, q, k_new, v_new, start, active=active,
                               need_select=need_select, perm=perm)


def dispatch_verify_append(layout, spec, state: Dict, k_new, v_new, start,
                           accepted, *, active=None, perm=None):
    """Route the commit of a verified chunk's accepted prefix to
    ``layout``'s verify_append hook."""
    return layout.verify_append(spec, state, k_new, v_new, start, accepted,
                                active=active, perm=perm)


def get_layout(name: str, shards: int = 1) -> DefaultLayout:
    """The layout ``name``; ``shards`` is the stripe count of
    ``coplace_shmap`` (the size of the JAX mesh's 'model' axis)."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if name == LAYOUT_COPLACE_SHMAP:
        return CoplaceShmapLayout(shards)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"layout {name!r} is not ported yet (ROADMAP Queue 1 item 9)")
    if name != LAYOUT_DEFAULT:
        raise ValueError(f"unknown attention layout {name!r}; ported layouts: "
                         f"{LAYOUT_DEFAULT}, {LAYOUT_COPLACE_SHMAP}")
    if shards != 1:
        raise ValueError("shards stripes the pages of the coplace_shmap layout "
                         "only")
    return DEFAULT

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


class CoplaceShmapLayout(DefaultLayout):
    """Co-placement over ``shards`` page stripes: striped page order at
    prefill and on chunk appends, split-KV partial attention per stripe and
    a log-sum-exp combine in decode."""

    name = LAYOUT_COPLACE_SHMAP

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

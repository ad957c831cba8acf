"""Compute-aware per-slot decode-step cost model (paper §IV-B; counterpart
of ``repro/sched/cost.py``, copied so that the port imports nothing of the
JAX package).

``sched/balance.py`` scores *residency* (page counts) — good enough at
admission time, but a slot mix that was page-balanced when admitted goes
lopsided as slots retire and contexts grow: streaming heads saturate at
``sink + local`` while retrieval heads keep growing with the selected
budget and the page-metadata scan, and a prefilling slot does chunk-sized
writes that no settled-page count sees. This module scores the *compute*
each slot will demand on its next engine step:

  decode slot    — streaming + retrieval head mix via ``slot_head_load``
                   at the speculative-verify horizon (``ctx + k - 1``: a
                   verify step appends up to k tokens before the host can
                   rebalance), with the striped-page read share capped at
                   the tiered hot set (``hot_cap``).
  prefill slot   — the chunk grant it will receive next step (computed
                   jointly across all prefilling slots via
                   ``chunk_allocation``, so backlog contention is scored,
                   not per-slot optimism) plus the settled-prefix gather
                   the chunk attends over.
  ready slot     — prompt fully fed, joins decode at the next phase
                   boundary: scored as a decode slot at its fed length.

Per-device aggregation goes through ``LayoutPlan.page_stripe_shards`` so
every registry layout inherits the model: the retrieval-heads' paged read
share stripes round-robin with the pages (coplace_shmap), while the
non-paged share pins to the slot's batch-axis bank.  Consumed by
``sched/rebalance.py`` and the engine's balance report.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.configs.base import H2ealConfig
from repro_torch.sched.balance import (
    chunk_allocation,
    slot_head_load,
    slot_pages,
)


@dataclass(frozen=True)
class SlotView:
    """Engine-side snapshot of one live slot (host mirrors only — building
    a view never touches device state)."""

    slot: int
    uid: int
    ctx: int            # tokens currently in the slot's cache
    prompt_left: int    # prompt tokens not yet fed (prefilling slots)
    phase: str          # "decode" | "prefill" | "ready"


@dataclass(frozen=True)
class SlotCost:
    """Scored per-step compute of one slot.

    ``compute`` is the total score (tokens of KV touched per step across
    all heads); ``paged_compute`` is the share attributable to striped
    page reads (moves with the pages under interleaved layouts, NOT with
    the slot index); ``pages`` is the device-resident page count backing
    that share (hot-capped under tiering)."""

    slot: int
    uid: int
    phase: str
    compute: float
    paged_compute: float
    pages: int


@dataclass(frozen=True)
class CostModel:
    """Frozen per-engine scoring parameters (head mix + serving mode)."""

    h2: H2ealConfig
    n_retrieval: int
    n_streaming: int
    hot_cap: Optional[int] = None
    spec_tokens: int = 0
    chunk_budget: int = 0

    @classmethod
    def from_config(cls, cfg, *, hot_cap: Optional[int] = None,
                    spec_tokens: int = 0,
                    chunk_budget: int = 0) -> "CostModel":
        """Head mix from the arch config: ``static_sparsity`` is the
        fraction of KV heads that are streaming (paper §IV-A)."""
        n_kv = int(cfg.num_kv_heads)
        nr = max(n_kv - round(n_kv * cfg.h2eal.static_sparsity), 0)
        return cls(h2=cfg.h2eal, n_retrieval=nr, n_streaming=n_kv - nr,
                   hot_cap=hot_cap, spec_tokens=int(spec_tokens),
                   chunk_budget=int(chunk_budget))

    # -- per-slot scores ----------------------------------------------------

    def _scored_pages(self, ctx: int) -> int:
        pages = slot_pages(ctx, self.h2.page_size)
        if self.hot_cap is not None:
            pages = min(pages, int(self.hot_cap))
        return pages

    def decode_cost(self, ctx: int) -> Tuple[float, float, int]:
        """(compute, paged_compute, pages) of one decode step at context
        ``ctx``, scored at the speculative-verify horizon."""
        horizon = max(int(self.spec_tokens) - 1, 0)
        c = int(ctx) + horizon
        stream = self.n_streaming * slot_head_load("streaming", self.h2, c)
        retr = self.n_retrieval * slot_head_load("retrieval", self.h2, c)
        # Streaming windows are per-slot ring buffers (never striped);
        # only the retrieval reads walk the interleaved pages.
        return stream + retr, retr, self._scored_pages(c)

    def prefill_cost(self, done: int, grant: int) -> Tuple[float, float, int]:
        """(compute, paged_compute, pages) of feeding ``grant`` chunk
        tokens onto ``done`` settled tokens: the chunk write itself plus
        the settled-prefix gather every chunk token attends over."""
        heads = self.n_streaming + self.n_retrieval
        gather = self.n_retrieval * slot_head_load("retrieval", self.h2,
                                                   int(done))
        return float(heads * int(grant)) + gather, gather, \
            self._scored_pages(int(done))

    def slot_costs(self, views: Sequence[SlotView], *,
                   n_shards: int = 1) -> List[SlotCost]:
        """Score every live slot. Prefill grants are allocated jointly
        (one shared ``chunk_budget`` per engine step, page-granular,
        device-aware — see ``chunk_allocation``); ``n_shards`` is the
        page striping factor the grants are placed against."""
        pre = [v for v in views if v.phase == "prefill"]
        grants = {}
        if pre:
            budget = self.chunk_budget if self.chunk_budget > 0 else \
                sum(v.prompt_left for v in pre)
            alloc = chunk_allocation([v.ctx for v in pre],
                                     [v.prompt_left for v in pre],
                                     budget, n_shards=max(int(n_shards), 1),
                                     page_size=self.h2.page_size)
            grants = {v.slot: g for v, g in zip(pre, alloc)}
        out: List[SlotCost] = []
        for v in views:
            if v.phase == "prefill":
                c, p, pg = self.prefill_cost(v.ctx, grants.get(v.slot, 0))
            else:  # decode / ready
                c, p, pg = self.decode_cost(v.ctx)
            out.append(SlotCost(slot=v.slot, uid=v.uid, phase=v.phase,
                                compute=c, paged_compute=p, pages=pg))
        return out


def slot_bank(slot: int, *, n_banks: int, max_batch: int) -> int:
    """Bank owning slot index ``slot`` under contiguous batch-axis
    blocking (the view a batch-sharded cache gives: bank j owns
    slots [j*B/n, (j+1)*B/n))."""
    assert 0 <= slot < max_batch
    return slot * n_banks // max_batch


def device_compute_loads(costs: Sequence[SlotCost], *, n_banks: int,
                         max_batch: int,
                         page_stripe_shards: int = 1) -> List[float]:
    """Aggregate slot costs into per-bank compute loads.

    The non-paged share of each slot pins to the bank owning its slot
    index (``slot_bank``).  When the layout stripes pages
    (``page_stripe_shards > 1``) the paged share is split proportional to
    each device's resident-page count under round-robin striping (floor
    share + one remainder page on the low-indexed devices, exactly as
    ``device_page_loads`` counts them), folded onto banks modulo
    ``n_banks`` — striped reads follow the *pages*, not the slot index,
    so migration moves only the pinned share."""
    loads = [0.0] * max(int(n_banks), 1)
    n_banks = len(loads)
    stripes = max(int(page_stripe_shards), 1)
    for c in costs:
        bank = slot_bank(c.slot, n_banks=n_banks, max_batch=max_batch)
        loads[bank] += c.compute - c.paged_compute
        if stripes > 1 and c.pages > 0:
            q, r = divmod(c.pages, stripes)
            per = [q + (1 if d < r else 0) for d in range(stripes)]
            total = sum(per)
            for d, p in enumerate(per):
                if p:
                    loads[d % n_banks] += c.paged_compute * p / total
        else:
            loads[bank] += c.paged_compute
    return loads

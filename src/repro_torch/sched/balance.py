"""Load balancing (counterpart of ``repro/sched/balance.py``).

Two halves, as in the reference:

* **Head placement** (paper §IV-B, cross-head co-placement). A decode step
  touches sink + local tokens of KV on a streaming head, and sink + local +
  the selected budget (plus the page-metadata scan) on a retrieval head.
  Within a tile of the bank grid (``sched/tiling.py``) the retrieval work
  is spread over all member banks; with interleaved storage each bank
  takes an equal 1/|tile| share whatever pages were selected. The
  ``ragged_*`` forms score a continuous batch, each slot at its own
  context length. The hbsim cycle model (``hbsim/sim.py``) and the serve
  CLI's ``--report-balance`` read them.
* **Page loads of a ragged batch** (paper §IV-C). Under the
  ``coplace_shmap`` layout a slot's pages are striped round-robin over the
  S stripes, so each stripe holds the floor share plus one remainder page
  on the first ``pages % S`` stripes. Remainders of different slots stack
  on the SAME low-indexed stripes, so a ragged batch is imbalanced by up to
  one page per slot. Balanced admission (``Engine(admission=
  "balanced")``) picks the queued request whose pages flatten that
  pile-up, and the chunk allocator hands the chunk budget to the slot
  whose next page lands on the least-loaded stripe. Under tiered
  residency (``hot_cap``) a slot counts only its device-resident hot set.

Host code on Python numbers: nothing here reads from the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

from repro_torch.configs.base import H2ealConfig
from repro_torch.sched.tiling import Tile


def head_load(kind: str, h2: H2ealConfig, metadata_scan_pages: int = 0) -> float:
    """Tokens of KV touched per decode step by one head."""
    if kind == "streaming":
        return h2.sink + h2.local
    # retrieval: sink + local + selected pages, plus the metadata pass,
    # which reads 2 d-vectors a page (2/page_size of a token's K bytes)
    meta_cost = 2.0 * metadata_scan_pages / h2.page_size
    return h2.sink + h2.local + h2.select_budget + meta_cost


@dataclass(frozen=True)
class BankLoad:
    bank: tuple
    load: float


def unbalanced_loads(tiles: Sequence[Tile], kinds: Dict[tuple, str],
                     h2: H2ealConfig, pages: int = 0) -> List[BankLoad]:
    """Naive one-head-per-bank placement: each bank carries its own head."""
    return [BankLoad(bank=b, load=head_load(kinds[b], h2, pages))
            for t in tiles for b in t.members]


def balanced_loads(tiles: Sequence[Tile], kinds: Dict[tuple, str],
                   h2: H2ealConfig, pages: int = 0) -> List[BankLoad]:
    """Co-placement: each tile's total load split evenly over its member
    banks (interleaved KV storage makes the split exact for any page
    selection)."""
    out: List[BankLoad] = []
    for t in tiles:
        total = sum(head_load(kinds[b], h2, pages) for b in t.members)
        share = total / len(t.members)
        out.extend(BankLoad(bank=b, load=share) for b in t.members)
    return out


def imbalance(loads: Sequence[BankLoad]) -> float:
    """max / mean bank load (1.0 = perfectly balanced)."""
    return load_imbalance([x.load for x in loads])


def slot_head_load(kind: str, h2: H2ealConfig, ctx: int) -> float:
    """Tokens of KV touched per decode step by one head of ONE slot at
    context length ``ctx`` (``head_load`` is the ctx -> inf limit, up to its
    metadata page count)."""
    ctx = int(ctx)
    if kind == "streaming":
        return float(min(ctx, h2.sink + h2.local))
    live_pages = -(-ctx // h2.page_size)
    meta_cost = 2.0 * live_pages / h2.page_size
    return float(min(ctx, h2.sink + h2.local + h2.select_budget)) + meta_cost


def ragged_head_load(kind: str, h2: H2ealConfig,
                     ctx_lengths: Sequence[int]) -> float:
    """Per-step load of one head over a ragged batch (the live slots'
    lengths only)."""
    return sum(slot_head_load(kind, h2, c) for c in ctx_lengths)


def ragged_loads(tiles: Sequence[Tile], kinds: Dict[tuple, str],
                 h2: H2ealConfig, ctx_lengths: Sequence[int],
                 *, balanced: bool = True) -> List[BankLoad]:
    """Per-bank loads of a ragged batch: ``balanced`` spreads each tile's
    total over its members (exact for any selection and any per-slot length,
    since interleaving stripes every slot's pages the same way); otherwise
    the naive one-head-per-bank placement."""
    out: List[BankLoad] = []
    for t in tiles:
        members = t.members
        per_head = {b: ragged_head_load(kinds[b], h2, ctx_lengths)
                    for b in members}
        if balanced:
            share = sum(per_head.values()) / len(members)
            out.extend(BankLoad(bank=b, load=share) for b in members)
        else:
            out.extend(BankLoad(bank=b, load=per_head[b]) for b in members)
    return out


def occupancy(active: Sequence[bool]) -> float:
    """Share of batch slots serving a request."""
    n = len(active)
    return sum(bool(a) for a in active) / n if n else 0.0


def slot_pages(ctx: int, page_size: int) -> int:
    """Live pages of one slot at context length ``ctx``."""
    return -(-int(ctx) // page_size) if ctx > 0 else 0


def _add_striped(loads: List[int], pages: int) -> None:
    q, r = divmod(pages, len(loads))
    for d in range(len(loads)):
        loads[d] += q + (1 if d < r else 0)


def device_page_loads(ctx_lengths: Sequence[int], *, n_shards: int,
                      page_size: int,
                      hot_cap: int | None = None) -> List[int]:
    """Per-stripe resident-page counts of a ragged batch under round-robin
    page striping. ``hot_cap`` models tiered residency
    (``core/cache.TieredPagedCache``): a slot keeps at most ``hot_cap``
    pages on the device, whatever its context, so admission under a tiered
    engine scores hot-set size, not total pages."""
    loads = [0] * n_shards
    for ctx in ctx_lengths:
        pages = slot_pages(ctx, page_size)
        if hot_cap is not None:
            pages = min(pages, int(hot_cap))
        _add_striped(loads, pages)
    return loads


def chunk_allocation(tokens_done: Sequence[int], tokens_left: Sequence[int],
                     budget: int, *, n_shards: int,
                     page_size: int) -> List[int]:
    """Split one engine step's chunked-prefill token budget over the
    prefilling slots.

    ``tokens_done[i]`` is slot i's prompt tokens already fed and
    ``tokens_left[i]`` the rest, slots in FIFO (admission) order. Grants are
    page-granular: each round gives one slot tokens up to its next page
    boundary, the slot whose page being written lands on the least-loaded
    stripe (loads seeded with the prefilling slots' resident pages; FIFO
    order breaks ties). With one stripe every load is equal, so the first
    unfinished slot wins each round: a plain FIFO fill. Returns the grants,
    which sum to min(budget, sum(tokens_left)).
    """
    if len(tokens_done) != len(tokens_left):
        raise ValueError("tokens_done and tokens_left differ in length")
    n = len(tokens_left)
    alloc = [0] * n
    left = [int(t) for t in tokens_left]
    done = [int(t) for t in tokens_done]
    shards = max(int(n_shards), 1)
    loads = [0] * shards
    for t in done:
        _add_striped(loads, slot_pages(t, page_size))
    budget = int(budget)
    while budget > 0 and any(lf > 0 for lf in left):
        best = None
        for i in range(n):
            if left[i] <= 0:
                continue
            d = ((done[i] + alloc[i]) // page_size) % shards
            if best is None or loads[d] < loads[best[1]]:
                best = (i, d)
        i, d = best
        fed = done[i] + alloc[i]
        if fed % page_size == 0:
            loads[d] += 1          # this grant opens a page on stripe d
        grant = min(left[i], budget, page_size - fed % page_size)
        alloc[i] += grant
        left[i] -= grant
        budget -= grant
    return alloc


def load_imbalance(vals: Sequence[float]) -> float:
    """max / mean of the loads (1.0 = perfectly balanced)."""
    vals = list(vals)
    mean = sum(vals) / len(vals) if vals else 0.0
    return max(vals) / mean if mean > 0 else 1.0


def admission_score(ctx_lengths: Sequence[int], candidate_ctx: int, *,
                    n_shards: int, page_size: int,
                    hot_cap: int | None = None,
                    spec_tokens: int | None = None,
                    prefill_done: Sequence[int] = (),
                    prefill_left: Sequence[int] = (),
                    chunk_budget: int | None = None) -> float:
    """Per-stripe page-load imbalance of the batch AFTER admitting a request
    of context ``candidate_ctx`` beside the live ``ctx_lengths``; lower is
    better, and the engine admits the queued request that minimises it.
    Under a tiered engine ``hot_cap`` caps each slot's scored pages at the
    hot-set size (``device_page_loads``).

    Under speculative decode (``spec_tokens=k``) every context is scored
    one verify step ahead, at ``ctx + k - 1``: a verify step appends up to
    k tokens before the host scores again, so a slot just below a page
    boundary opens its next page within the chunk.

    Under chunked prefill the PREFILLING slots come through
    ``prefill_done``/``prefill_left`` (tokens fed / still to come): they
    count at the page span they will reach (done + left), and the score also
    sees the prefill compute in flight: ``chunk_budget`` is split over the
    prefilling slots and the candidate by ``chunk_allocation`` (the engine's
    own allocator), and each granted slot adds one unit of load on the
    stripe its next page lands on.
    """
    done = [int(d) for d in prefill_done]
    left = [int(t) for t in prefill_left]
    if len(done) != len(left):
        raise ValueError("prefill_done and prefill_left differ in length")
    horizon = max(int(spec_tokens) - 1, 0) if spec_tokens else 0
    ctxs = [int(c) + horizon for c in ctx_lengths]
    ctxs.extend(d + t + horizon for d, t in zip(done, left))
    ctxs.append(int(candidate_ctx) + horizon)
    shards = max(int(n_shards), 1)
    loads = device_page_loads(ctxs, n_shards=shards, page_size=page_size,
                              hot_cap=hot_cap)
    if chunk_budget:
        alloc = chunk_allocation(done + [0], left + [int(candidate_ctx)],
                                 int(chunk_budget), n_shards=shards,
                                 page_size=page_size)
        feed = done + [0]
        for i, grant in enumerate(alloc):
            if grant > 0:
                loads[(feed[i] // page_size) % shards] += 1
    return load_imbalance(loads)

"""Page-load balancing of a ragged batch (counterpart of the page-load part
of ``repro/sched/balance.py``, paper §IV-C).

Under the ``coplace_shmap`` layout a slot's pages are striped round-robin
over the S stripes, so each stripe holds the floor share plus one remainder
page on the first ``pages % S`` stripes. Remainders of different slots
stack on the SAME low-indexed stripes, so a ragged batch is imbalanced by
up to one page per slot. Balanced admission (``Engine(admission=
"balanced")``) picks the queued request whose pages flatten that pile-up,
and the chunk allocator hands the chunk budget to the slot whose next page
lands on the least-loaded stripe. Host code on Python ints: nothing here
reads from the card.
"""
from __future__ import annotations

from typing import List, Sequence


def slot_pages(ctx: int, page_size: int) -> int:
    """Live pages of one slot at context length ``ctx``."""
    return -(-int(ctx) // page_size) if ctx > 0 else 0


def _add_striped(loads: List[int], pages: int) -> None:
    q, r = divmod(pages, len(loads))
    for d in range(len(loads)):
        loads[d] += q + (1 if d < r else 0)


def device_page_loads(ctx_lengths: Sequence[int], *, n_shards: int,
                      page_size: int) -> List[int]:
    """Per-stripe resident-page counts of a ragged batch under round-robin
    page striping."""
    loads = [0] * n_shards
    for ctx in ctx_lengths:
        _add_striped(loads, slot_pages(ctx, page_size))
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
                    prefill_done: Sequence[int] = (),
                    prefill_left: Sequence[int] = (),
                    chunk_budget: int | None = None) -> float:
    """Per-stripe page-load imbalance of the batch AFTER admitting a request
    of context ``candidate_ctx`` beside the live ``ctx_lengths``; lower is
    better, and the engine admits the queued request that minimises it.

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
    ctxs = [int(c) for c in ctx_lengths]
    ctxs.extend(d + t for d, t in zip(done, left))
    ctxs.append(int(candidate_ctx))
    shards = max(int(n_shards), 1)
    loads = device_page_loads(ctxs, n_shards=shards, page_size=page_size)
    if chunk_budget:
        alloc = chunk_allocation(done + [0], left + [int(candidate_ctx)],
                                 int(chunk_budget), n_shards=shards,
                                 page_size=page_size)
        feed = done + [0]
        for i, grant in enumerate(alloc):
            if grant > 0:
                loads[(feed[i] // page_size) % shards] += 1
    return load_imbalance(loads)

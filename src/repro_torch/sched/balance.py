"""Chunked-prefill token budget split (counterpart of
``repro/sched/balance.py::chunk_allocation``).

Only the single-shard case is ported: with one device every page lands on
the same device, so the JAX allocator's least-loaded-device choice always
picks the first unfinished slot, and the split is a plain FIFO fill. The
balanced (sharded) admission it also serves is ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from typing import List, Sequence


def chunk_allocation(tokens_done: Sequence[int], tokens_left: Sequence[int],
                     budget: int, *, page_size: int) -> List[int]:
    """Split one engine step's chunk budget over the prefilling slots.

    ``tokens_done[i]`` is slot i's prompt tokens already fed and
    ``tokens_left[i]`` the rest, slots in FIFO (admission) order. Grants
    are page-granular: each round gives the first unfinished slot tokens up
    to its next page boundary. Returns the grants, which sum to
    min(budget, sum(tokens_left)).
    """
    if len(tokens_done) != len(tokens_left):
        raise ValueError("tokens_done and tokens_left differ in length")
    fed = [int(t) for t in tokens_done]
    left = [int(t) for t in tokens_left]
    alloc = [0] * len(left)
    budget = int(budget)
    i = 0
    while budget > 0 and i < len(left):
        if left[i] <= 0:
            i += 1
            continue
        grant = min(left[i], budget, page_size - fed[i] % page_size)
        alloc[i] += grant
        fed[i] += grant
        left[i] -= grant
        budget -= grant
    return alloc

"""Rebalance planner: slot migrations that flatten device compute (§IV-B;
counterpart of ``repro/sched/rebalance.py``).

The engine admits requests balanced (``sched/balance.py``) but load
drifts afterwards: slots retire, contexts grow, and the streaming /
retrieval head mix makes per-bank compute diverge from the page counts
admission scored. The paper's scheduler re-spreads attention work across
HB banks when this drift appears; our batch-dimension analogue is to
*migrate a slot to a different slot index* so the batch-axis sharding
places its compute on an underloaded bank.

``plan_rebalance`` turns a cost snapshot (``sched/cost.py``) into a
small, safe move list:

  * targets come from greedy-LPT (``map_slots``) over total slot
    compute — the same 4/3-approximation the balance report scores
    placements with;
  * a move only lands in a FREE slot index inside the target bank's
    block (one copy-then-reset step in the engine; no live-live swaps, so
    a half-applied plan is still a valid state);
  * executed moves free their source index for later candidates within
    the same plan;
  * hysteresis — the plan is empty unless it improves the max/mean
    imbalance by at least ``min_gain`` (the engine adds a step cooldown
    on top), so the planner never thrashes on noise.

Token traces are bit-exact under any plan: a migration copies the cache
rows, lengths, and sampling lanes verbatim, and sampling keys are owned
by (seed, uid) — not the slot index.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

from repro_torch.sched.balance import load_imbalance
from repro_torch.sched.cost import SlotCost, device_compute_loads, slot_bank
from repro_torch.sched.mapping import map_slots


@dataclass(frozen=True)
class Migration:
    """One slot move: ``src`` slot index → free ``dst`` slot index."""

    src: int
    dst: int
    uid: int
    compute: float   # the moved slot's scored compute (for reporting)


@dataclass(frozen=True)
class RebalancePlan:
    moves: Tuple[Migration, ...]
    imbalance_before: float
    imbalance_after: float

    @property
    def gain(self) -> float:
        return self.imbalance_before - self.imbalance_after


def plan_rebalance(costs: Sequence[SlotCost], free_slots: Sequence[int], *,
                   n_banks: int, max_batch: int,
                   page_stripe_shards: int = 1,
                   min_gain: float = 0.0) -> RebalancePlan:
    """Propose slot migrations flattening per-bank compute.

    ``costs`` are the live slots' scores (``CostModel.slot_costs``),
    ``free_slots`` the currently unoccupied slot indices. Deterministic:
    ties in LPT keep index order and free destinations are taken lowest
    index first."""
    costs = list(costs)
    before = load_imbalance(device_compute_loads(
        costs, n_banks=n_banks, max_batch=max_batch,
        page_stripe_shards=page_stripe_shards))
    if len(costs) < 2 or n_banks <= 1 or not free_slots:
        return RebalancePlan((), before, before)

    target = map_slots([c.compute for c in costs], n_banks)
    free_by_bank: List[List[int]] = [[] for _ in range(n_banks)]
    for s in sorted(set(int(f) for f in free_slots)):
        free_by_bank[slot_bank(s, n_banks=n_banks, max_batch=max_batch)] \
            .append(s)

    moves: List[Migration] = []
    placed = {c.slot: c.slot for c in costs}
    for bank, members in enumerate(target.banks):
        for i in members:
            c = costs[i]
            cur = slot_bank(placed[c.slot], n_banks=n_banks,
                            max_batch=max_batch)
            if cur == bank or not free_by_bank[bank]:
                continue
            dst = free_by_bank[bank].pop(0)
            moves.append(Migration(src=placed[c.slot], dst=dst, uid=c.uid,
                                   compute=c.compute))
            # the vacated source index is free for later candidates
            free_by_bank[cur].append(placed[c.slot])
            free_by_bank[cur].sort()
            placed[c.slot] = dst

    if not moves:
        return RebalancePlan((), before, before)
    sim = [SlotCost(slot=placed[c.slot], uid=c.uid, phase=c.phase,
                    compute=c.compute, paged_compute=c.paged_compute,
                    pages=c.pages) for c in costs]
    after = load_imbalance(device_compute_loads(
        sim, n_banks=n_banks, max_batch=max_batch,
        page_stripe_shards=page_stripe_shards))
    if before - after < float(min_gain):
        return RebalancePlan((), before, before)
    return RebalancePlan(tuple(moves), before, after)

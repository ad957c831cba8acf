"""Adaptive heterogeneous mapping: n_h KV heads onto n_b banks (paper §IV-C.1;
counterpart of ``repro/sched/mapping.py``).

Cases:
  (a) n_b divisible by n_h — one stage; each head gets n_b/n_h banks
      (tensor parallelism within the group).
  (b) n_h > n_b — heads split into ceil(n_h/n_b) disjoint subsets executed
      as a sequential pipeline; each subset reduces to (a)/(c).
  (c) n_h < n_b, not divisible — greedy decomposition of n_h into distinct
      divisors of n_b (largest first); each part is a stage of case (a).

The paper's greedy can be infeasible (e.g. n_h=5, n_b=9: distinct divisors
{1,3} sum to at most 4) — we fall back to a final stage where the remaining
heads r get floor(n_b/r) banks each with n_b mod r banks idle, and report
the idle count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class Stage:
    """One pipeline stage: ``heads`` executed with ``banks_per_head`` banks
    each (idle_banks banks unused)."""

    heads: tuple  # head ids in this stage
    banks_per_head: int
    idle_banks: int = 0


@dataclass(frozen=True)
class MappingPlan:
    n_heads: int
    n_banks: int
    stages: tuple  # tuple[Stage]

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def total_idle(self) -> int:
        return sum(s.idle_banks for s in self.stages)

    def validate(self) -> None:
        seen = []
        for s in self.stages:
            used = len(s.heads) * s.banks_per_head + s.idle_banks
            assert used == self.n_banks, (
                f"stage uses {used} banks != {self.n_banks}")
            seen.extend(s.heads)
        assert sorted(seen) == list(range(self.n_heads)), (
            "heads not partitioned exactly once")


def _divisors(n: int) -> List[int]:
    return sorted((d for d in range(1, n + 1) if n % d == 0), reverse=True)


def _greedy_distinct_divisors(n_h: int, n_b: int) -> List[int] | None:
    """Greedy largest-first decomposition of n_h into distinct divisors of
    n_b; None if infeasible."""
    parts: List[int] = []
    rest = n_h
    for d in _divisors(n_b):
        if d <= rest and d not in parts:
            parts.append(d)
            rest -= d
        if rest == 0:
            return parts
    return None


@dataclass(frozen=True)
class SlotAssignment:
    """Whole-slot → bank placement for a ragged batch (used when pages are
    NOT interleaved, so a slot's KV pins to one bank and the per-bank load
    is the sum of its slots' loads)."""

    n_banks: int
    banks: tuple     # tuple[tuple[int, ...]] — slot ids per bank
    loads: tuple     # per-bank total load

    @property
    def imbalance(self) -> float:
        from repro_torch.sched.balance import load_imbalance
        return load_imbalance(self.loads)


def map_slots(slot_loads, n_banks: int) -> SlotAssignment:
    """Greedy LPT: place the heaviest slot on the least-loaded bank.

    The ragged-batch analogue of `map_heads` — the paper balances a fixed
    head population across banks (§IV-C.1); a continuous-batching batch
    additionally has per-SLOT load raggedness (each slot sits at its own
    context length). LPT is the standard 4/3-approximation for makespan
    and is what the engine's balance report scores non-interleaved
    placements with; under interleaved striping the split is exact and
    this mapping is unnecessary (see sched/balance.py).
    """
    assert n_banks >= 1
    order = sorted(range(len(slot_loads)), key=lambda i: -slot_loads[i])
    banks: List[List[int]] = [[] for _ in range(n_banks)]
    loads = [0.0] * n_banks
    for i in order:
        b = min(range(n_banks), key=lambda j: loads[j])
        banks[b].append(i)
        loads[b] += float(slot_loads[i])
    return SlotAssignment(n_banks=n_banks,
                          banks=tuple(tuple(b) for b in banks),
                          loads=tuple(loads))


def map_heads(n_h: int, n_b: int) -> MappingPlan:
    """Compute the stage plan mapping n_h KV heads onto n_b banks."""
    assert n_h >= 1 and n_b >= 1
    stages: List[Stage] = []
    head0 = 0

    def emit_subset(count: int) -> None:
        """Map `count` heads (<= n_b) onto all n_b banks."""
        nonlocal head0
        if n_b % count == 0:  # case (a)
            stages.append(Stage(
                heads=tuple(range(head0, head0 + count)),
                banks_per_head=n_b // count))
            head0 += count
            return
        parts = _greedy_distinct_divisors(count, n_b)  # case (c)
        if parts is None:
            # paper's greedy infeasible: single stage with idle banks
            bph = n_b // count
            stages.append(Stage(
                heads=tuple(range(head0, head0 + count)),
                banks_per_head=bph,
                idle_banks=n_b - bph * count))
            head0 += count
            return
        for part in parts:
            stages.append(Stage(
                heads=tuple(range(head0, head0 + part)),
                banks_per_head=n_b // part))
            head0 += part

    if n_h <= n_b:
        emit_subset(n_h)
    else:  # case (b): sequential pipeline of <=n_b-head subsets
        rest = n_h
        while rest > 0:
            emit_subset(min(rest, n_b))
            rest -= min(rest, n_b)

    plan = MappingPlan(n_heads=n_h, n_banks=n_b, stages=tuple(stages))
    plan.validate()
    return plan

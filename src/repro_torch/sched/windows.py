"""Fused decode-window budgets (counterpart of ``repro/sched/windows.py``).

Between two page-selection boundaries the engine can run every reuse step
of the stretch as ONE dispatch (``Engine(decode_window=w)``): a captured
window of steps with device-side retirement. The window tells each slot how
many tokens it may emit before its active lane flips, since the host learns
of retirements only at the window's end, so the budget vector encodes every
stop condition the per-step loop would have checked on the host:

* the request's remaining token budget (``max_new`` countdown),
* the cache capacity ceiling (``lengths`` < capacity),
* the selection boundary itself (no slot crosses ``phase % w == 0`` inside
  the window: the select step is a step of its own).

Pure numpy on the host mirrors; nothing here touches the card.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def window_budgets(active: np.ndarray, remaining: np.ndarray,
                   lengths: np.ndarray, *, capacity: int,
                   phase_residue: int, share_window: int,
                   window: int) -> Tuple[int, np.ndarray]:
    """Per-slot emission budgets for one fused decode window.

    active/remaining/lengths: the engine's (B,) host mirrors. The window
    starts with every active slot at the same share-window residue
    ``phase_residue`` (READY slots join at a shared boundary, so this is an
    invariant of the engine, not a request).

    Returns ``(n_useful, budgets)``: the number of window iterations that
    can do useful work (the budget of every slot that survives the whole
    window, so survivors stay phase-aligned at the next boundary) and the
    (B,) int32 budget vector, >= 1 for every active slot and 0 elsewhere.
    A slot whose budget b < n_useful retires inside the window after
    emitting exactly b tokens.
    """
    if not 1 <= phase_residue < share_window:
        raise ValueError(
            f"fused window must start strictly inside a share window: "
            f"residue {phase_residue} vs share_window {share_window}")
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    n_useful = min(int(window), int(share_window) - int(phase_residue))
    budgets = np.zeros(active.shape[0], np.int32)
    for i in np.nonzero(active)[0]:
        b = min(n_useful, int(remaining[i]), int(capacity) - int(lengths[i]))
        if b < 1:
            raise ValueError(
                f"active slot {i} has no token budget (remaining="
                f"{remaining[i]}, lengths={lengths[i]}, capacity="
                f"{capacity}); it should have retired at the boundary")
        budgets[i] = b
    return n_useful, budgets

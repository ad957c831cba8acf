"""Scheduling of the serving engine and the paper's placement planners
(counterpart of ``repro/sched/``, with the same exports)."""
from repro_torch.sched.mapping import (  # noqa: F401
    MappingPlan,
    SlotAssignment,
    Stage,
    map_heads,
    map_slots,
)
from repro_torch.sched.tiling import (  # noqa: F401
    Tile,
    grid_coords,
    head_permutation,
    manhattan,
    solve_tiling,
)
from repro_torch.sched.cost import (  # noqa: F401
    CostModel,
    SlotCost,
    SlotView,
    device_compute_loads,
    slot_bank,
)
from repro_torch.sched.rebalance import (  # noqa: F401
    Migration,
    RebalancePlan,
    plan_rebalance,
)
from repro_torch.sched.windows import (  # noqa: F401
    window_budgets,
)
from repro_torch.sched.balance import (  # noqa: F401
    admission_score,
    balanced_loads,
    chunk_allocation,
    device_page_loads,
    head_load,
    imbalance,
    load_imbalance,
    occupancy,
    ragged_head_load,
    ragged_loads,
    slot_head_load,
    slot_pages,
    unbalanced_loads,
)

"""PyTorch port, the paper's placement planners (``repro_torch.sched``):
tiling, head mapping, both halves of balance, the cost model and the
rebalance planner, against the JAX package's functions of the same names
on the same inputs.

These are host functions on Python numbers with the same arithmetic in the
same order, so the results are EQUAL: ``==`` on ints, floats, lists and
(through ``dataclasses.asdict``) on the dataclasses. The inputs are those
of tests/test_sched.py and of the unit half of tests/test_rebalance.py,
over the paper models the port registers.
"""
import dataclasses
import random

import pytest

from repro import sched as J
from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro_torch import sched as T
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch as tget_arch
from repro_torch.configs import reduced as treduced
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

PAPER_MODELS = ("llama2-7b", "llama3-8b", "mistral-7b")
# the MoE family: active parameters count only the top-k experts
MOE_MODELS = ("qwen3-moe-235b-a22b", "kimi-k2-1t-a32b")
# the recurrent mixers: 9 attention layers of 54 (zamba2), none (xlstm)
RECURRENT_MODELS = ("zamba2-2.7b", "xlstm-125m")
H2S = (dict(), dict(sink=4, local=8, select_budget=16, page_size=8),
       dict(sink=4, local=256, select_budget=4096, page_size=32))


def _h2(**kw):
    return tbase.H2ealConfig(**kw), jbase.H2ealConfig(**kw)


def _same(a, b):
    """Equal results: dataclasses field for field, the rest by ``==``."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    elif isinstance(a, (list, tuple)) and a and dataclasses.is_dataclass(a[0]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(tbase.REGISTRY))
def test_config_counting_properties_equal(name):
    for t, j in ((tget_arch(name), jget_arch(name)),
                 (treduced(tget_arch(name)), jreduced(jget_arch(name)))):
        assert t.attention_layers == j.attention_layers
        assert t.has_attention == j.has_attention
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert [t.layer_has_ffn(i) for i in range(t.num_layers)] == [
            j.layer_has_ffn(i) for i in range(j.num_layers)]


@pytest.mark.parametrize("n_b", [1, 2, 3, 4, 5, 7, 8, 9, 12, 16, 64])
def test_map_heads_equal(n_b):
    """Cases (a), (b), (c) and the greedy-infeasible fallback: every head
    count from 1 to 128 onto ``n_b`` banks."""
    for n_h in range(1, 129):
        t, j = T.map_heads(n_h, n_b), J.map_heads(n_h, n_b)
        _same(t, j)
        assert (t.num_stages, t.total_idle) == (j.num_stages, j.total_idle)


def _tiling_cases():
    """name -> [(retrieval banks, streaming banks)]."""
    coords = T.grid_coords(4, 4)
    corners = [(0, 0), (0, 3), (3, 0), (3, 3)]
    cases = {
        "corners": [(corners, [c for c in coords if c not in corners])],
        "line": [([(0, i) for i in range(0, 8, 2)], [(0, i) for i in range(1, 8, 2)])],
        "single_type": [(coords[:5], []), ([], coords[:3])],
    }
    for n_r in range(1, 9):
        cases[f"mix{n_r}"] = [(coords[:n_r], coords[n_r:n_r + n_s])
                              for n_s in range(1, 9)]
    return cases


@pytest.mark.parametrize("case", sorted(_tiling_cases()))
def test_solve_tiling_equal(case):
    for retr, stream in _tiling_cases()[case]:
        (tt, td), (jt, jd) = T.solve_tiling(retr, stream), J.solve_tiling(retr, stream)
        assert td == jd
        _same(tt, jt)


def test_grid_manhattan_and_head_permutation_equal():
    import numpy as np

    assert T.grid_coords(4, 4) == J.grid_coords(4, 4)
    assert T.grid_coords(3, 5) == J.grid_coords(3, 5)
    pts = T.grid_coords(4, 4)
    assert [T.manhattan(a, b) for a in pts for b in pts] == [
        J.manhattan(a, b) for a in pts for b in pts]
    alpha = np.random.default_rng(0).random(8).round(2)  # ties included
    np.testing.assert_array_equal(T.head_permutation(alpha, 0.5),
                                  J.head_permutation(alpha, 0.5))


def _kinds(n_kv, sparsity):
    coords = T.grid_coords(4, 4)[:n_kv]
    nr = max(n_kv - round(n_kv * sparsity), 0)
    retr, stream = coords[:nr], coords[nr:]
    kinds = {c: ("retrieval" if c in retr else "streaming") for c in coords}
    return retr, stream, kinds


@pytest.mark.parametrize("h2kw", H2S, ids=["default", "small", "paper"])
def test_head_placement_loads_equal(h2kw):
    """``head_load``, the naive and co-placed bank loads and their
    imbalance (Fig 11's inputs), uniform and ragged."""
    th2, jh2 = _h2(**h2kw)
    for kind in ("streaming", "retrieval"):
        for pages in (0, 8, 8192):
            assert T.head_load(kind, th2, pages) == J.head_load(kind, jh2, pages)
        for ctx in (0, 1, 7, 8, 9, 100, 300, 5000, 70000):
            assert T.slot_head_load(kind, th2, ctx) == J.slot_head_load(kind, jh2, ctx)
        ctxs = [3, 64, 260, 4100, 9000]
        assert T.ragged_head_load(kind, th2, ctxs) == J.ragged_head_load(kind, jh2, ctxs)
    for n_kv in (4, 8, 16):
        retr, stream, kinds = _kinds(n_kv, 0.5)
        tiles, _ = T.solve_tiling(retr, stream)
        jtiles, _ = J.solve_tiling(retr, stream)
        for pages in (0, 8192):
            u = T.unbalanced_loads(tiles, kinds, th2, pages)
            b = T.balanced_loads(tiles, kinds, th2, pages)
            _same(u, J.unbalanced_loads(jtiles, kinds, jh2, pages))
            _same(b, J.balanced_loads(jtiles, kinds, jh2, pages))
            assert T.imbalance(u) == J.imbalance(J.unbalanced_loads(
                jtiles, kinds, jh2, pages))
            assert T.imbalance(b) == J.imbalance(J.balanced_loads(
                jtiles, kinds, jh2, pages))
        for ctxs in ([], [5], [17, 300, 4096, 12000]):
            for bal in (True, False):
                _same(T.ragged_loads(tiles, kinds, th2, ctxs, balanced=bal),
                      J.ragged_loads(jtiles, kinds, jh2, ctxs, balanced=bal))


def test_occupancy_and_load_imbalance_equal():
    for active in ([], [True], [True, False, False, True], [False] * 3):
        assert T.occupancy(active) == J.occupancy(active)
    for vals in ([], [0.0, 0.0], [1.0, 2.0, 3.5], [7, 0, 0]):
        assert T.load_imbalance(vals) == J.load_imbalance(vals)


@pytest.mark.parametrize("hot_cap", [None, 1, 3, 40])
def test_page_loads_and_admission_score_equal(hot_cap):
    """The page-load half with the tiered ``hot_cap``; the admission score
    with speculation and the in-flight chunk budget."""
    rng = random.Random(hot_cap or 0)
    for _ in range(40):
        ctxs = [rng.randint(0, 900) for _ in range(rng.randint(0, 5))]
        shards = rng.choice([1, 2, 4, 8])
        page = rng.choice([8, 32])
        assert T.device_page_loads(ctxs, n_shards=shards, page_size=page,
                                   hot_cap=hot_cap) == J.device_page_loads(
            ctxs, n_shards=shards, page_size=page, hot_cap=hot_cap)
        done = [rng.randint(0, 200) for _ in range(rng.randint(0, 3))]
        left = [rng.randint(1, 200) for _ in done]
        kw = dict(n_shards=shards, page_size=page, hot_cap=hot_cap,
                  spec_tokens=rng.choice([None, 4]), prefill_done=done,
                  prefill_left=left, chunk_budget=rng.choice([None, 8, 64]))
        cand = rng.randint(1, 600)
        assert T.admission_score(ctxs, cand, **kw) == J.admission_score(ctxs, cand, **kw)


def test_map_slots_equal():
    """The cases of tests/test_sched.py's map_slots block, and random
    loads."""
    cases = [([5.0] * 6, 3), ([0.0] * 4, 2), ([7.0, 3.0], 5), ([], 3), ([9.0], 3)]
    for seed in range(30):
        n = random.Random(seed).randint(0, 24)
        loads = [random.Random(seed + i).uniform(0.0, 1e6) for i in range(n)]
        cases.append((loads, 1 + seed % 8))
    for loads, n_banks in cases:
        t, j = T.map_slots(loads, n_banks), J.map_slots(loads, n_banks)
        _same(t, j)
        assert t.imbalance == j.imbalance


def _cost_models(cfg_t, cfg_j):
    for hot in (None, 3):
        for spec in (0, 4):
            for budget in (0, 8):
                kw = dict(hot_cap=hot, spec_tokens=spec, chunk_budget=budget)
                yield (T.CostModel.from_config(cfg_t, **kw),
                       J.CostModel.from_config(cfg_j, **kw))


@pytest.mark.parametrize("name", PAPER_MODELS + ("smollm-360m",) + MOE_MODELS
                         + RECURRENT_MODELS)
def test_cost_model_equal(name):
    """``CostModel.from_config`` over the serving modes (tiered hot cap,
    speculative horizon, chunk budget); each slot's decode and prefill cost;
    the joint ``slot_costs`` of a mixed batch; ``device_compute_loads``
    striped and not."""
    cfg_t, cfg_j = tget_arch(name), jget_arch(name)
    if name == "smollm-360m":
        cfg_t, cfg_j = treduced(cfg_t), jreduced(cfg_j)
    views = [(0, 0, 37, 0, "decode"), (1, 1, 0, 64, "prefill"),
             (3, 2, 500, 0, "ready"), (4, 3, 9, 40, "prefill"),
             (6, 4, 9000, 0, "decode")]
    for tm, jm in _cost_models(cfg_t, cfg_j):
        _same(tm, jm)
        for ctx in (0, 1, 33, 300, 8192):
            assert tm.decode_cost(ctx) == jm.decode_cost(ctx)
            assert tm.prefill_cost(ctx, 8) == jm.prefill_cost(ctx, 8)
        for shards in (1, 2, 4):
            tc = tm.slot_costs([T.SlotView(*v) for v in views], n_shards=shards)
            jc = jm.slot_costs([J.SlotView(*v) for v in views], n_shards=shards)
            _same(tc, jc)
            for n_banks, stripes in ((1, 1), (2, 1), (4, 1), (2, 4), (4, 8)):
                kw = dict(n_banks=n_banks, max_batch=8, page_stripe_shards=stripes)
                assert T.device_compute_loads(tc, **kw) == J.device_compute_loads(jc, **kw)


def test_slot_bank_equal():
    for max_batch in (1, 4, 7, 8):
        for n_banks in (1, 2, 3, 4):
            assert [T.slot_bank(s, n_banks=n_banks, max_batch=max_batch)
                    for s in range(max_batch)] == [
                J.slot_bank(s, n_banks=n_banks, max_batch=max_batch)
                for s in range(max_batch)]


def _costs(mod, spec):
    return [mod.SlotCost(slot=s, uid=u, phase="decode", compute=float(c),
                         paged_compute=float(p), pages=g)
            for s, u, c, p, g in spec]


PLAN_CASES = [
    # (costs (slot, uid, compute, paged, pages), free, n_banks, max_batch, stripes, min_gain)
    ([(0, 0, 5, 0, 0), (2, 2, 5, 0, 0)], [1, 3], 2, 4, 1, 0.0),   # balanced
    ([(0, 0, 5, 0, 0), (1, 1, 5, 0, 0)], [2, 3], 2, 4, 1, 0.0),   # crowded bank
    ([(0, 0, 5, 0, 0), (1, 1, 5, 0, 0)], [2, 3], 2, 4, 1, 2.0),   # hysteresis
    ([(0, 0, 9, 0, 0), (1, 1, 1, 0, 0)], [], 2, 4, 1, 0.0),       # no free slot
    ([(0, 0, 9, 0, 0), (1, 1, 1, 0, 0)], [2, 3], 1, 4, 1, 0.0),   # one bank
    ([(0, 0, 9, 0, 0)], [2, 3], 2, 4, 1, 0.0),                    # one slot
    ([(0, 0, 9, 0, 0), (1, 1, 5, 0, 0), (4, 4, 1, 0, 0)], [2, 3, 5, 6, 7], 4, 8, 1, 0.0),
    ([(0, 0, 9, 0, 0), (1, 1, 5, 0, 0), (4, 4, 1, 0, 0)], [7, 6, 5, 3, 2], 4, 8, 1, 0.0),
    ([(0, 0, 10, 4, 2), (1, 1, 6, 2, 1), (2, 2, 30, 20, 9)], [3], 2, 4, 2, 0.02),
    ([(0, 0, 10, 4, 2), (1, 1, 6, 2, 1), (2, 2, 30, 20, 9)], [3], 2, 4, 1, 0.02),
]


@pytest.mark.parametrize("case", range(len(PLAN_CASES)))
def test_plan_rebalance_equal(case):
    spec, free, n_banks, max_batch, stripes, gain = PLAN_CASES[case]
    kw = dict(n_banks=n_banks, max_batch=max_batch, page_stripe_shards=stripes,
              min_gain=gain)
    t = T.plan_rebalance(_costs(T, spec), free, **kw)
    j = J.plan_rebalance(_costs(J, spec), free, **kw)
    _same(t, j)
    assert t.gain == j.gain


def test_device_compute_loads_of_the_unit_cases_equal():
    """tests/test_rebalance.py's conservation and striping cases."""
    spec = [(0, 0, 10.0, 4.0, 2), (3, 1, 6.0, 2.0, 1)]
    for kw in (dict(n_banks=2, max_batch=4),
               dict(n_banks=2, max_batch=4, page_stripe_shards=2)):
        assert T.device_compute_loads(_costs(T, spec), **kw) == \
            J.device_compute_loads(_costs(J, spec), **kw)

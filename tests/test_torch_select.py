"""PyTorch port, a retrieval layer's select step on the CPU against JAX.

``ops.page_select`` on CPU tensors runs its plain version
(``ref.page_select_ref``); here it is held against the JAX reference's
select step on the same numpy inputs: ``paging.score_pages`` ->
``select_pages`` -> ``accumulate_importance`` -> the ``need_select``
``where`` (``repro/core/hybrid_attention.py:333-343``), and, with
``minus_one_masked``, the co-placed layout's two-stage top-k
(``repro/core/hybrid_attention.py:684-695``, each stripe's top-k, then a
top-k of their stripe-major concatenation, -1 where masked). The selection
must be equal and the importance within 1e-5 relative (the scores are f32
sums in different orders).

The co-placed form's two stages equal one stable top-K over all slots
(score descending, lower slot first), -1 where the score is masked: a
Hypothesis property over stripes, slots, K and tied scores, run in JAX.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import paging as jpaging
from repro_torch.kernels import ops, ref as tref
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

SINK, LOCAL, PAGE = 4, 8, 4
NEG_INF = -1e30
NEG_INF_HALF = -5e29
RTOL = 1e-5


@functools.partial(jax.jit, static_argnums=(1, 2))
def jax_two_stage(scores, top_k: int, shards: int):
    """The co-placed selection as the reference's shard_map body computes
    it, with its all_gather written as a stack over the stripes."""
    c_loc = scores.shape[-1] // shards
    k_eff = min(top_k, c_loc)
    v_all, i_all = [], []
    for i in range(shards):
        v_loc, i_loc = jax.lax.top_k(scores[..., i * c_loc:(i + 1) * c_loc], k_eff)
        v_all.append(v_loc)
        i_all.append(i_loc + i * c_loc)
    v_all, i_all = jnp.stack(v_all), jnp.stack(i_all)   # (nsh, B, Hr, k)
    bsz, hr = v_all.shape[1], v_all.shape[2]
    v_cat = v_all.transpose(1, 2, 0, 3).reshape(bsz, hr, shards * k_eff)
    i_cat = i_all.transpose(1, 2, 0, 3).reshape(bsz, hr, shards * k_eff)
    sel_v, sel_pos = jax.lax.top_k(v_cat, min(top_k, shards * k_eff))
    sel = jnp.take_along_axis(i_cat, sel_pos, axis=2)
    sel = jnp.where(sel_v > NEG_INF_HALF, sel, -1).astype(jnp.int32)
    if sel.shape[2] < top_k:
        pad = jnp.full(sel.shape[:2] + (top_k - sel.shape[2],), -1, jnp.int32)
        sel = jnp.concatenate([sel, pad], axis=2)
    return sel


def jax_select(q, tmin, tmax, start, ctx, sel_prev, imp_prev, need, *, top_k, shards=None):
    """The reference's select step: (sel, imp) as numpy arrays."""
    ctx_j = jnp.asarray(ctx) if isinstance(ctx, np.ndarray) else ctx
    scores = jpaging.score_pages(jnp.asarray(q), jnp.asarray(tmin), jnp.asarray(tmax),
                                 jnp.asarray(start), ctx_j, sink=SINK, local=LOCAL,
                                 page=PAGE)
    sel = (jpaging.select_pages(scores, top_k) if shards is None
           else jax_two_stage(scores, top_k, shards))
    imp = jpaging.accumulate_importance(jnp.asarray(imp_prev), scores)
    if need is not None:
        ns = jnp.asarray(need)[:, None, None]
        sel = jnp.where(ns, sel, jnp.asarray(sel_prev))
        imp = jnp.where(ns, imp, jnp.asarray(imp_prev))
    return np.asarray(sel), np.asarray(imp)


# (label, b, hkv, group, c, ctx (int or one per row), top_k, stripes, need)
CASES = [
    ("tensor ctx", 2, 2, 2, 24, [90, 61], 6, 4, None),
    ("int ctx", 2, 2, 2, 24, 90, 6, 4, None),
    ("forced ties", 2, 2, 2, 24, [90, 77], 8, 4, None),
    ("fewer selectable than K", 2, 2, 2, 24, [30, 40], 8, 4, None),
    ("K >= C", 2, 2, 2, 10, [41, 38], 12, 2, None),
    ("mixed need", 3, 2, 2, 24, [90, 70, 81], 6, 3, [True, False, True]),
]


def _inputs(label, b, hkv, group, c, ctx, top_k, need, seed):
    rng = np.random.default_rng(seed)
    d = 16
    if label == "forced ties":
        # small integers: every score is exact in f32 on both sides, and
        # pages p and p + 4 hold the same τ rows, so their scores tie
        q = rng.integers(-2, 3, (b, hkv * group, d)).astype(np.float32)
        lo = rng.integers(-3, 4, (b, hkv, 4, d)).astype(np.float32)
        hi = lo + rng.integers(0, 3, (b, hkv, 4, d)).astype(np.float32)
        tmin, tmax = np.tile(lo, (1, 1, c // 4, 1)), np.tile(hi, (1, 1, c // 4, 1))
    else:
        q = rng.standard_normal((b, hkv * group, d)).astype(np.float32)
        lo = rng.standard_normal((b, hkv, c, d)).astype(np.float32)
        hi = rng.standard_normal((b, hkv, c, d)).astype(np.float32)
        tmin, tmax = np.minimum(lo, hi), np.maximum(lo, hi)
    ctx_rows = np.asarray(ctx if isinstance(ctx, list) else [ctx] * b)
    first = np.arange(c) * PAGE
    start = np.where(first[None] < ctx_rows[:, None], first[None], -1).astype(np.int32)
    start = np.ascontiguousarray(np.broadcast_to(start[:, None], (b, hkv, c)))
    empty = (start < 0)[..., None]
    tmin = np.where(empty, np.inf, tmin).astype(np.float32)
    tmax = np.where(empty, -np.inf, tmax).astype(np.float32)
    sel_prev = rng.integers(-1, c, (b, hkv, top_k)).astype(np.int32)
    imp_prev = rng.standard_normal((b, hkv, c)).astype(np.float32)
    ctx = ctx_rows.astype(np.int32) if isinstance(ctx, list) else ctx
    need = None if need is None else np.asarray(need)
    return q, tmin, tmax, start, ctx, sel_prev, imp_prev, need


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_page_select_matches_jax(case):
    label, b, hkv, group, c, ctx, top_k, stripes, need = case
    args = _inputs(label, b, hkv, group, c, ctx, top_k, need, seed=c + b)
    t = [None if x is None else (torch.from_numpy(x) if isinstance(x, np.ndarray) else x)
         for x in args]
    for shards in (None, stripes):
        want_sel, want_imp = jax_select(*args, top_k=top_k, shards=shards)
        got_sel, got_imp = ops.page_select(*t, sink=SINK, local=LOCAL, page=PAGE,
                                           top_k=top_k, minus_one_masked=shards is not None)
        assert got_sel.dtype == torch.int32 and got_imp.dtype == torch.float32
        np.testing.assert_array_equal(got_sel.numpy(), want_sel)
        np.testing.assert_allclose(got_imp.numpy(), want_imp, rtol=RTOL, atol=0)
    if label == "fewer selectable than K":  # the default layout fills with
        sel = jax_select(*args, top_k=top_k)[0]  # masked pages, in slot order
        ok = tref.selectable_pages(t[3], t[4], sink=SINK, local=LOCAL, page=PAGE).numpy()
        for idx in np.ndindex(*ok.shape[:2]):
            n_ok = int(ok[idx].sum())
            tail = sel[idx][n_ok:]
            assert n_ok < top_k and list(tail) == sorted(tail) and not ok[idx][tail].any()


@settings(deadline=None, max_examples=30)
@given(shards=st.integers(1, 8), c_loc=st.integers(1, 39), top_k=st.integers(1, 79),
       seed=st.integers(0, 2 ** 31 - 1))
def test_coplace_two_stages_equal_one_stable_top_k(shards, c_loc, top_k, seed):
    """Scores from 7 values (ties everywhere), 40% of them masked."""
    rng = np.random.default_rng(seed)
    c = shards * c_loc
    scores = rng.choice(np.float32([-2.0, -1.0, 0.0, 0.5, 1.0, 2.5, 3.0]), (2, 2, c))
    scores = np.where(rng.random((2, 2, c)) < 0.4, np.float32(NEG_INF), scores)
    scores = scores.astype(np.float32)
    want = np.asarray(jax_two_stage(jnp.asarray(scores), top_k, shards))
    st_scores = torch.from_numpy(scores)
    one = tref.select_top_k(st_scores, top_k, minus_one_masked=True)
    two = tref.select_top_k(st_scores, top_k, minus_one_masked=True, shards=shards)
    np.testing.assert_array_equal(one.numpy(), want)
    np.testing.assert_array_equal(two.numpy(), want)

"""PyTorch port, the eviction pool (``kv_budget``; paper §IV-A.3 "memory
consideration"): ``cache.pool_append``, ``paging.evict_lowest``,
``paging.slots_of_positions`` and ``hybrid_attention.decode_attention_pool``
against the JAX package (``impl="ref"``) on the CPU, in the setting of
tests/test_eviction.py (its shapes and H²EAL settings; f32 caches on
both sides, where tests/test_eviction.py keeps JAX's bf16 default).

Inputs come from numpy with a fixed seed and go through both sides. The
pool's integer state (page starts, selections) is held bit for bit at
every step; its importance within 1e-6 relative (a sum of page scores,
f32 sums that the two frameworks take in different orders); K/V, τ and
outputs to 2e-5 (f32, summation order).
The port's select step keeps ``lax.top_k``'s tie order (equal scores: the
lower slot first), so selections agree exactly, ties included.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import H2ealConfig as JH2
from repro.core import cache as jcache
from repro.core import hybrid_attention as jhattn
from repro.core import paging as jpaging
from repro_torch.configs.base import H2ealConfig as TH2
from repro_torch.core import cache as tcache
from repro_torch.core import hybrid_attention as thattn
from repro_torch.core import paging as tpaging
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

TOL = 2e-5
B, HQ, HKV, D = 1, 4, 2, 32
P, SINK, LOCAL = 8, 2, 16


def _specs(budget=0, n_kv=HKV, batch_q=HQ):
    kw = dict(sink=SINK, local=LOCAL, page_size=P, select_budget=32,
              share_window=1, kv_budget=budget)
    return (thattn.AttnSpec(n_q=batch_q, n_kv=n_kv, head_dim=D, h2=TH2(**kw)),
            jhattn.AttnSpec(n_q=batch_q, n_kv=n_kv, head_dim=D, h2=JH2(**kw)))


def _fresh(tspec, jspec, c_pool, b=B):
    nr, k = tspec.n_retrieval, tspec.h2.top_k_pages
    tp = tcache.make_paged_cache(b, nr, c_pool, P, D, k, dtype=torch.float32,
                                 device="cpu")
    ts = tcache.make_stream_cache(b, tspec.n_streaming, SINK, LOCAL + P, D,
                                  dtype=torch.float32, device="cpu")
    jp = jcache.make_paged_cache(b, nr, c_pool, P, D, k, dtype=jnp.float32)
    js = jcache.make_stream_cache(b, jspec.n_streaming, SINK, LOCAL + P, D,
                                  dtype=jnp.float32)
    return tp, ts, jp, js


def _step_inputs(rng, b=B, hq=HQ, hkv=HKV):
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, D), (b, hkv, D), (b, hkv, D))]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol, rtol=0)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


def _same_pool(t, j, msg=""):
    _eq(t.page_start, j.page_start, msg)
    _eq(t.sel_idx, j.sel_idx, msg)
    # the importance sums the steps' page scores, f32 sums over the group and
    # D taken in another order by XLA's einsum: within 1e-6 of its magnitude
    np.testing.assert_allclose(np.asarray(t.importance), np.asarray(j.importance),
                               rtol=1e-6, atol=1e-6, err_msg=msg)
    for f in ("k_pages", "v_pages", "tau_min", "tau_max"):
        _close(getattr(t, f), getattr(j, f))


def _pool_state(rng, b, h, c, *, ties):
    """A pool whose slots hold pages in a permuted order, some dead, with
    importance values that tie where ``ties``."""
    starts = np.full((b, h, c), -1, np.int32)
    for bi in range(b):
        for hi in range(h):
            n_live = rng.integers(c // 2, c + 1)
            pages = rng.permutation(c + 4)[:n_live] * P
            slots = rng.permutation(c)[:n_live]
            starts[bi, hi, slots] = pages
    imp = rng.integers(0, 4, (b, h, c)).astype(np.float32) if ties else \
        rng.standard_normal((b, h, c)).astype(np.float32)
    return starts, imp


@pytest.mark.parametrize("ties", [False, True])
def test_evict_lowest_and_slots_of_positions_equal_jax(ties):
    rng = np.random.default_rng(3 + ties)
    starts, imp = _pool_state(rng, 2, 3, 12, ties=ties)
    _eq(tpaging.evict_lowest(torch.from_numpy(imp), torch.from_numpy(starts)),
        jpaging.evict_lowest(jnp.asarray(imp), jnp.asarray(starts)))
    dup = starts.copy()
    dup[:, :, -1] = dup[:, :, 0]  # a start held twice: the lower slot wins
    for positions in (np.arange(0, 20 * P, P, dtype=np.int32),
                      rng.integers(-1, 20, (2, 3, 7)).astype(np.int32) * P):
        for ps in (starts, dup):
            _eq(tpaging.slots_of_positions(torch.from_numpy(ps),
                                           torch.from_numpy(positions)),
                jpaging.slots_of_positions(jnp.asarray(ps), jnp.asarray(positions)))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("length", [0, 5, 24, 40, 61])
def test_pool_append_equals_jax(length, ties):
    """One append into a permuted pool: into the page already open at
    ``length``, else into a dead slot, else over the lowest-importance
    unprotected page; the opened page's τ and importance restart."""
    rng = np.random.default_rng(length + 100 * ties)
    b, h, c = 2, 3, 8
    starts, imp = _pool_state(rng, b, h, c, ties=ties)
    if length == 61:  # a full pool: every slot live, so a page is evicted
        starts = np.stack([np.stack([rng.permutation(c) * P for _ in range(h)])
                           for _ in range(b)]).astype(np.int32)
    kp, vp = (rng.standard_normal((b, h, c, P, D)).astype(np.float32) for _ in range(2))
    tmin = rng.standard_normal((b, h, c, D)).astype(np.float32)
    tmax = tmin + np.abs(rng.standard_normal((b, h, c, D))).astype(np.float32)
    sel = np.zeros((b, h, 4), np.int32)
    kn, vn = (rng.standard_normal((b, h, D)).astype(np.float32) for _ in range(2))
    tp = tcache.PagedCache(*(torch.from_numpy(x.copy()) for x in
                             (kp, vp, tmin, tmax, imp, starts, sel)))
    jp = jcache.PagedCache(*(jnp.asarray(x) for x in (kp, vp, tmin, tmax, imp, starts, sel)))
    kw = dict(page=P, sink=SINK, local=LOCAL)
    got = tcache.pool_append(tp, torch.from_numpy(kn), torch.from_numpy(vn), length, **kw)
    want = jcache.pool_append(jp, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(length), **kw)
    assert got is tp  # written in place
    _same_pool(got, want)


@functools.lru_cache(maxsize=None)
def _jax_pool_step(jspec):
    """JAX's ``decode_attention_pool`` select step, jitted once a spec (the
    length traced)."""
    return jax.jit(functools.partial(jhattn.decode_attention_pool, jspec, do_select=True))


def _run_pool(tspec, jspec, c_pool, steps, seed, *, tp=None, jp=None, check=None):
    """``steps`` decode steps of the pool on both sides from one state;
    ``check(step, t_out, j_out, tp, jp)`` after each."""
    ftp, ts, fjp, js = _fresh(tspec, jspec, c_pool)
    tp = ftp if tp is None else tp
    jp = fjp if jp is None else jp
    rng = np.random.default_rng(seed)
    for step in range(steps):
        q, k, v = _step_inputs(rng, hkv=tspec.n_kv)
        to, tp, ts = thattn.decode_attention_pool(
            tspec, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            tp, ts, step, do_select=True)
        jo, jp, js = _jax_pool_step(jspec)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jp, js, jnp.int32(step))
        check(step, to, jo, tp, jp)
    return tp, jp


def test_ample_pool_matches_decode_attention_and_jax():
    """A pool that holds the whole context: the port's pool decode equals its
    own position-indexed ``decode_attention`` and JAX's pool decode, step by
    step over 40 steps."""
    tspec, jspec = _specs()
    c_pool = 16
    std_p, std_s, _, _ = _fresh(tspec, jspec, c_pool)
    rng = np.random.default_rng(0)
    inputs = [_step_inputs(rng) for _ in range(40)]

    def check(step, to, jo, tp, jp):
        nonlocal std_p, std_s
        q, k, v = (torch.from_numpy(x) for x in inputs[step])
        so, std_p, std_s = thattn.decode_attention(tspec, q, k, v, std_p, std_s,
                                                   step, do_select=True)
        _close(to, so)
        _close(to, jo)
        _same_pool(tp, jp, f"step {step}")

    _run_pool(tspec, jspec, c_pool, 40, 0, check=check)


def test_tight_pool_equals_jax_step_by_step():
    """64 tokens of pool for an 80-token context: page starts and
    selections equal JAX's bit for bit at every step, importance and
    outputs within tolerance; sink and local pages stay resident and a
    middle page is evicted."""
    tspec, jspec = _specs(budget=64)
    c_pool = 8
    evicted = []

    def check(step, to, jo, tp, jp):
        assert torch.isfinite(to).all(), step
        _close(to, jo)
        _same_pool(tp, jp, f"step {step}")
        evicted.append(set(range(0, step + 1, P)) - set(tp.page_start[0, 0].tolist()))

    tp, _ = _run_pool(tspec, jspec, c_pool, 80, 1000, check=check)
    live = tp.page_start[0, 0].tolist()
    assert 0 in live
    first_local = (80 - LOCAL) // P
    assert all(pos in live for pos in range(first_local * P, 80, P))
    assert evicted[-1], "no page was evicted"


def test_permuted_pool_ties_break_by_slot_as_jax():
    """A pool that starts full, its pages in permuted slots, every page's τ
    the same (so every selectable page scores alike) and importance tied:
    both sides select, evict and attend alike, the lower slot first."""
    tspec, jspec = _specs(budget=96, n_kv=2)
    c_pool, h = 12, tspec.n_retrieval
    rng = np.random.default_rng(5)
    starts = np.stack([rng.permutation(c_pool) * P for _ in range(h)])[None]
    starts = starts.astype(np.int32)
    kp, vp = (rng.standard_normal((1, h, c_pool, P, D)).astype(np.float32)
              for _ in range(2))
    row = rng.standard_normal(D).astype(np.float32)
    tmin = np.broadcast_to(row - 1, (1, h, c_pool, D)).copy()
    tmax = np.broadcast_to(row + 1, (1, h, c_pool, D)).copy()
    imp = np.zeros((1, h, c_pool), np.float32)
    sel = np.zeros((1, h, tspec.h2.top_k_pages), np.int32)
    arrays = (kp, vp, tmin, tmax, imp, starts, sel)
    # the pool holds positions up to 12 pages; decode from the last page on
    base = c_pool * P - 1

    def run(steps):
        tp = tcache.PagedCache(*(torch.from_numpy(x.copy()) for x in arrays))
        jp = jcache.PagedCache(*(jnp.asarray(x) for x in arrays))
        ts = tcache.make_stream_cache(1, tspec.n_streaming, SINK, LOCAL + P, D,
                                      dtype=torch.float32, device="cpu")
        js = jcache.make_stream_cache(1, jspec.n_streaming, SINK, LOCAL + P, D,
                                      dtype=jnp.float32)
        rng2 = np.random.default_rng(9)
        for i in range(steps):
            q, k, v = _step_inputs(rng2, hkv=2)
            to, tp, ts = thattn.decode_attention_pool(
                tspec, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                tp, ts, base + i, do_select=True)
            jo, jp, js = _jax_pool_step(jspec)(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), jp, js, jnp.int32(base + i))
            _close(to, jo)
            _same_pool(tp, jp, f"step {i}")
        return tp

    tp = run(18)  # crosses two page boundaries, each evicting
    assert sorted(set(tp.page_start.flatten().tolist()) - set(range(0, c_pool * P, P)))

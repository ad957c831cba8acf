"""PyTorch port, decode-state core: caches, paging, hybrid attention and the
model layers against the JAX package (``impl="ref"``) on the CPU.

Inputs come from numpy with a fixed seed and go through both sides.
Tolerance: 2e-5 in f32; integer state (positions, page starts) is equal.
Selections are compared through ``token_validity`` as sets of attended
token positions, since ``torch.topk`` and ``lax.top_k`` break ties
differently.
"""
import dataclasses
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
from repro.models import layers as jlayers
from repro_torch.configs.base import H2ealConfig as TH2
from repro_torch.core import cache as tcache
from repro_torch.core import hybrid_attention as thattn
from repro_torch.core import layouts as tlayouts
from repro_torch.core import paging as tpaging
from repro_torch.models import layers as tlayers

TOL = 2e-5
H2 = dict(sink=2, local=16, page_size=8, select_budget=32, share_window=2)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol, rtol=0)


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _same_paged(t, j):
    for f in ("k_pages", "v_pages", "tau_min", "tau_max", "importance"):
        _close(getattr(t, f), getattr(j, f))
    _eq(t.page_start, j.page_start)


def _same_stream(t, j):
    _close(t.k, j.k)
    _close(t.v, j.v)
    _eq(t.pos, j.pos)


def _specs(n_q=8, n_kv=4, d=16, **h2):
    kw = dict(H2, **h2)
    return (jhattn.AttnSpec(n_q=n_q, n_kv=n_kv, head_dim=d, h2=JH2(**kw)),
            thattn.AttnSpec(n_q=n_q, n_kv=n_kv, head_dim=d, h2=TH2(**kw)))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_rms_norm_dense_swiglu_match_jax():
    rng = np.random.default_rng(0)
    x, w = _np(rng, 3, 5, 16), _np(rng, 16) * 0.1
    _close(tlayers.rms_norm(_t(x), _t(w), 1e-6), jlayers.rms_norm(x, w, 1e-6))
    wg, wu, wd = _np(rng, 16, 24), _np(rng, 16, 24), _np(rng, 24, 16)
    _close(tlayers.swiglu(_t(x), _t(wg), _t(wu), _t(wd)),
           jlayers.swiglu(x, wg, wu, wd), 1e-4)


@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_jax(batched):
    rng = np.random.default_rng(1)
    x = _np(rng, 2, 7, 3, 32)
    pos = np.arange(100, 107) if not batched else np.stack(
        [np.arange(7), np.arange(50, 57)])
    jc, js = jlayers.rope_cos_sin(jnp.asarray(pos), 32, 5e5)
    tc, ts = tlayers.rope_cos_sin(torch.from_numpy(pos), 32, 5e5)
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    _close(tlayers.apply_rope(_t(x), tc, ts), jlayers.apply_rope(x, jc, js), 1e-4)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def test_paged_cache_from_prefill_and_appends_match_jax():
    rng = np.random.default_rng(2)
    b, s, h, d, p, c = 2, 24, 2, 16, 8, 6
    k, v = _np(rng, b, s, h, d), _np(rng, b, s, h, d)
    j = jcache.paged_cache_from_prefill(jnp.asarray(k), jnp.asarray(v), c, p, 4)
    t = tcache.paged_cache_from_prefill(_t(k), _t(v), c, p, 4)
    _same_paged(t, j)
    for length in range(s, s + 11):  # crosses into two fresh pages
        kn, vn = _np(rng, b, h, d), _np(rng, b, h, d)
        j = jcache.paged_cache_append(j, jnp.asarray(kn), jnp.asarray(vn), length)
        t = tcache.paged_cache_append(t, _t(kn), _t(vn), length)
    _same_paged(t, j)


@pytest.mark.parametrize("s", [3, 20, 45])
def test_stream_cache_from_prefill_and_ring_appends_match_jax(s):
    rng = np.random.default_rng(s)
    b, h, d, sink, cap = 2, 2, 16, 2, 24
    k, v = _np(rng, b, s, h, d), _np(rng, b, s, h, d)
    j = jcache.stream_cache_from_prefill(jnp.asarray(k), jnp.asarray(v), sink=sink,
                                         local_cap=cap, length=s)
    t = tcache.stream_cache_from_prefill(_t(k), _t(v), sink=sink, local_cap=cap,
                                         length=s)
    _same_stream(t, j)
    for length in range(s, s + 30):  # wraps the ring
        kn, vn = _np(rng, b, h, d), _np(rng, b, h, d)
        j = jcache.stream_cache_append(j, jnp.asarray(kn), jnp.asarray(vn), length,
                                       sink=sink)
        t = tcache.stream_cache_append(t, _t(kn), _t(vn), length, sink=sink)
    _same_stream(t, j)


def test_full_cache_append_matches_jax():
    rng = np.random.default_rng(4)
    k = _np(rng, 2, 3, 10, 16)
    j = jcache.FullCache(k=jnp.asarray(k), v=jnp.asarray(k))
    t = tcache.FullCache(k=_t(k), v=_t(k))
    kn = _np(rng, 2, 3, 16)
    j = jcache.full_cache_append(j, jnp.asarray(kn), jnp.asarray(kn), 7)
    t = tcache.full_cache_append(t, _t(kn), _t(kn), 7)
    _close(t.k, j.k)
    _close(t.v, j.v)


@pytest.mark.parametrize("s", [32, 45])  # a page multiple, and not
def test_init_decode_state_matches_jax(s):
    rng = np.random.default_rng(s)
    jspec, tspec = _specs()
    k, v = _np(rng, 2, s, 4, 16), _np(rng, 2, s, 4, 16)
    perm = rng.permutation(4).astype(np.int32)
    jp, js = jhattn.init_decode_state(jspec, jnp.asarray(k), jnp.asarray(v), s,
                                      s + 24, jnp.asarray(perm))
    tp, ts = thattn.init_decode_state(tspec, _t(k), _t(v), s, s + 24, _t(perm))
    _same_paged(tp, jp)
    _same_stream(ts, js)


# ---------------------------------------------------------------------------
# paging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctx", [20, 37, 90])
def test_selection_matches_through_token_validity(ctx):
    """Few selectable pages (ties among masked pages) and many."""
    rng = np.random.default_rng(ctx)
    b, h, g, d, p, c, top_k = 2, 2, 2, 16, 8, 13, 4
    kw = dict(sink=2, local=16, page=p)
    keys = _np(rng, b, h, c * p, d)
    pos = np.arange(c * p)
    keys[:, :, pos >= ctx] = 0
    kp = keys.reshape(b, h, c, p, d)
    live = (pos < ctx).reshape(c, p)[None, None, :, :, None]
    tmin = np.where(live, kp, np.inf).min(3).astype(np.float32)
    tmax = np.where(live, kp, -np.inf).max(3).astype(np.float32)
    start = np.where(np.arange(c) * p < ctx, np.arange(c) * p, -1).astype(np.int32)
    start = np.broadcast_to(start, (b, h, c)).copy()
    q = _np(rng, b, h * g, d)

    js = jpaging.score_pages(jnp.asarray(q), jnp.asarray(tmin), jnp.asarray(tmax),
                             jnp.asarray(start), ctx, **kw)
    ts = tpaging.score_pages(_t(q), _t(tmin), _t(tmax), _t(start), ctx, **kw)
    _close(ts, js)
    jsel = jpaging.select_pages(js, top_k)
    tsel = tpaging.select_pages(ts, top_k)
    jslots = jpaging.attended_page_slots(jsel, ctx, **kw)
    tslots = tpaging.attended_page_slots(tsel, ctx, **kw)
    jv = np.asarray(jpaging.token_validity(jslots, jnp.asarray(start), ctx,
                                           top_k=top_k, **kw))
    tv = tpaging.token_validity(tslots, _t(start), ctx, top_k=top_k, **kw).numpy()
    jtok = (np.asarray(jslots)[..., None] * p + np.arange(p)).reshape(b, h, -1)
    ttok = (tslots.numpy()[..., None] * p + np.arange(p)).reshape(b, h, -1)
    for bi in range(b):
        for hi in range(h):
            _eq(np.sort(ttok[bi, hi][tv[bi, hi]]), np.sort(jtok[bi, hi][jv[bi, hi]]))
    jk, _ = jpaging.gather_pages(jnp.asarray(kp), jnp.asarray(kp), jslots)
    tk, _ = tpaging.gather_pages(_t(kp), _t(kp), tslots)
    assert tk.shape == jk.shape
    imp = _np(rng, b, h, c)
    _close(tpaging.accumulate_importance(_t(imp), ts),
           jpaging.accumulate_importance(jnp.asarray(imp), js), 1e-4)


# ---------------------------------------------------------------------------
# hybrid attention
# ---------------------------------------------------------------------------


def test_prefill_attention_matches_jax_with_random_perm():
    rng = np.random.default_rng(5)
    jspec, tspec = _specs()
    q, k, v = _np(rng, 2, 40, 8, 16), _np(rng, 2, 40, 4, 16), _np(rng, 2, 40, 4, 16)
    perm = rng.permutation(4).astype(np.int32)
    want = jhattn.prefill_attention(jspec, jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(perm))
    got = thattn.prefill_attention(tspec, _t(q), _t(k), _t(v), _t(perm))
    _close(got, want)


@pytest.mark.parametrize("s", [40, 45])  # a page multiple, and not
def test_decode_attention_select_and_reuse_steps_match_jax(s):
    """Several decode steps, select on even steps and reuse on odd ones, a
    random head permutation; outputs, caches and the attended token sets
    agree after every step."""
    rng = np.random.default_rng(s)
    jspec, tspec = _specs(select_budget=16)
    n_steps = 7
    cap = s + n_steps + 8
    k, v = _np(rng, 2, s, 4, 16), _np(rng, 2, s, 4, 16)
    perm = rng.permutation(4).astype(np.int32)
    jp, js = jhattn.init_decode_state(jspec, jnp.asarray(k), jnp.asarray(v), s, cap,
                                      jnp.asarray(perm))
    tp, ts = thattn.init_decode_state(tspec, _t(k), _t(v), s, cap, _t(perm))
    jsteps = [jax.jit(functools.partial(jhattn.decode_attention, jspec,
                                        do_select=sel)) for sel in (False, True)]
    for i in range(n_steps):
        q, kn, vn = _np(rng, 2, 8, 16), _np(rng, 2, 4, 16), _np(rng, 2, 4, 16)
        sel = i % 2 == 0
        jo, jp, js = jsteps[sel](jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                                 jp, js, jnp.int32(s + i), perm=jnp.asarray(perm))
        to, tp, ts = thattn.decode_attention(
            tspec, _t(q), _t(kn), _t(vn), tp, ts, s + i, do_select=sel, perm=_t(perm))
        _close(to, jo)
        _same_stream(ts, js)
        _same_paged(tp, jp)


def test_full_decode_attention_matches_jax():
    rng = np.random.default_rng(6)
    jspec, tspec = _specs(enabled=False)
    k = _np(rng, 2, 4, 30, 16)
    jc = jcache.FullCache(k=jnp.asarray(k), v=jnp.asarray(k[::-1]))
    tc = tcache.FullCache(k=_t(k), v=_t(k[::-1]))
    for length in (11, 12, 13):
        q, kn, vn = _np(rng, 2, 8, 16), _np(rng, 2, 4, 16), _np(rng, 2, 4, 16)
        jo, jc = jhattn.full_decode_attention(jspec, jnp.asarray(q), jnp.asarray(kn),
                                              jnp.asarray(vn), jc, length)
        to, tc = thattn.full_decode_attention(tspec, _t(q), _t(kn), _t(vn), tc, length)
        _close(to, jo)


def test_decode_refuses_a_cache_without_room_for_the_local_section():
    _, tspec = _specs()
    rng = np.random.default_rng(7)
    s = 40
    k = _t(_np(rng, 1, s, 4, 16))
    tp, ts = thattn.init_decode_state(tspec, k, k, s, s)
    q, kn = _t(_np(rng, 1, 8, 16)), _t(_np(rng, 1, 4, 16))
    with pytest.raises(ValueError, match="capacity"):
        thattn.decode_attention(tspec, q, kn, kn, tp, ts, s, do_select=True)


def test_gspmd_layouts_raise():
    """default and coplace_shmap are ported; the GSPMD placements, which
    need more than one device, raise and name their ROADMAP item."""
    assert tlayouts.get_layout("default").name == "default"
    assert tlayouts.get_layout("coplace_shmap").name == "coplace_shmap"
    for name in ("head", "coplace", "interleave"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tlayouts.get_layout(name)
    with pytest.raises(ValueError, match="unknown"):
        tlayouts.get_layout("nope")
    _, tspec = _specs()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        thattn.prefill_attention(dataclasses.replace(tspec, window=8),
                                 torch.zeros(1, 4, 8, 16), torch.zeros(1, 4, 4, 16),
                                 torch.zeros(1, 4, 4, 16))

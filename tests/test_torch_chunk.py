"""PyTorch port, chunked prefill and ragged decode: the plain versions of
``chunk_attention`` and ``chunk_attention_paged``, the ragged and chunk
cache appends, the chunk validity helpers, ``chunk_prefill_attention``,
ragged ``decode_attention`` and the model's ``prefill_chunk`` against the
JAX package (``impl="ref"``) on the CPU.

Inputs come from numpy with a fixed seed and go through both sides.
Tolerance: 2e-5 in f32 at kernel and attention outputs; 2e-4 for logits
after the whole layer stack; integer state (positions, page starts) equal.
Selections are compared through ``token_validity`` as sets of attended
token positions (``torch.topk`` and ``lax.top_k`` break ties differently).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import H2ealConfig as JH2
from repro.core import cache as jcache
from repro.core import hybrid_attention as jhattn
from repro.core import paging as jpaging
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.runtime import serve as jserve
from repro.sched import balance as jbalance
from repro.serving.engine import _reset_slot as j_reset_slot
from repro_torch import configs as tconfigs
from repro_torch.configs.base import H2ealConfig as TH2
from repro_torch.core import cache as tcache
from repro_torch.core import hybrid_attention as thattn
from repro_torch.core import paging as tpaging
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.sched import balance as tbalance
from repro_torch.serving.engine import _reset_slot as t_reset_slot

TOL = 2e-5
LOGIT_TOL = 2e-4
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


def _specs(n_q=8, n_kv=4, d=16, **h2):
    kw = dict(H2, **h2)
    return (jhattn.AttnSpec(n_q=n_q, n_kv=n_kv, head_dim=d, h2=JH2(**kw)),
            thattn.AttnSpec(n_q=n_q, n_kv=n_kv, head_dim=d, h2=TH2(**kw)))


def _paged_pair(rng, b, h, c, p, d, written):
    """A (JAX, port) pair of paged caches with the first ``written[b]``
    positions of slot b filled, the rest at the empty values."""
    kp, vp = _np(rng, b, h, c, p, d), _np(rng, b, h, c, p, d)
    pos = np.arange(c * p).reshape(c, p)
    live = pos[None, None, :, :] < np.asarray(written)[:, None, None, None]
    kp, vp = np.where(live[..., None], kp, 0), np.where(live[..., None], vp, 0)
    tmin = np.where(live[..., None], kp, np.inf).min(3).astype(np.float32)
    tmax = np.where(live[..., None], kp, -np.inf).max(3).astype(np.float32)
    start = np.where(live[..., 0], np.arange(c)[None, None] * p, -1).astype(np.int32)
    start = np.broadcast_to(start, (b, h, c)).copy()
    imp = _np(rng, b, h, c)
    sel = rng.integers(0, c, (b, h, 4)).astype(np.int32)
    leaves = (kp.astype(np.float32), vp.astype(np.float32), tmin, tmax, imp, start, sel)
    j = jcache.PagedCache(*(jnp.asarray(x) for x in leaves))
    t = tcache.PagedCache(*(_t(x) for x in leaves))
    return j, t


def _same_paged(t, j):
    for f in ("k_pages", "v_pages", "tau_min", "tau_max", "importance"):
        _close(getattr(t, f), getattr(j, f))
    _eq(t.page_start, j.page_start)
    _eq(t.sel_idx, j.sel_idx)


def _same_stream(t, j):
    _close(t.k, j.k)
    _close(t.v, j.v)
    _eq(t.pos, j.pos)


# ---------------------------------------------------------------------------
# plain versions of the two kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", [1, 2, 4])
def test_chunk_attention_plain_matches_jax(group):
    rng = np.random.default_rng(group)
    b, cq, hkv, t, d = 2, 7, 2, 29, 16
    q = _np(rng, b, cq, hkv * group, d)
    k, v = _np(rng, b, hkv, t, d), _np(rng, b, hkv, t, d)
    valid = rng.random((b, hkv, cq, t)) < 0.5
    valid[1, 0, 3] = False  # an all-invalid row gives 0
    want = jref.chunk_attention_ref(*(jnp.asarray(x) for x in (q, k, v, valid)))
    got = ops.chunk_attention(*(torch.from_numpy(x) for x in (q, k, v, valid)))
    assert got.shape == (b, cq, hkv * group, d)
    _close(got, want)
    assert float(got[1, 3, :group].abs().max()) == 0.0


@pytest.mark.parametrize("written,start", [
    ((0, 0), (0, 0)),        # start 0: only the chunk itself
    ((21, 40), (21, 40)),    # partially written last page
    ((24, 13), (17, 9)),     # keys written at or past start are not attended
])
def test_chunk_attention_paged_plain_matches_jax(written, start):
    rng = np.random.default_rng(sum(written) + sum(start))
    b, cq, hr, g, c, p, d = 2, 6, 2, 2, 7, 8, 16
    jc, tc = _paged_pair(rng, b, hr, c, p, d, written)
    q = _np(rng, b, cq, hr * g, d)
    kn, vn = _np(rng, b, cq, hr, d), _np(rng, b, cq, hr, d)
    st = np.asarray(start, np.int32)
    want = jref.chunk_attention_paged_ref(
        jnp.asarray(q), jc.k_pages, jc.v_pages, jc.page_start, jnp.asarray(st),
        jnp.asarray(kn), jnp.asarray(vn))
    got = ops.chunk_attention_paged(_t(q), tc.k_pages, tc.v_pages, tc.page_start,
                                    _t(st), _t(kn), _t(vn))
    _close(got, want)


def test_chunk_attention_paged_casts_the_chunk_to_the_cache_dtype():
    """bf16 cache, f32 chunk: both sides attend the chunk KV rounded to
    bf16, as a post-append read would return it (JAX's ops-level cast).
    The bf16 outputs may differ by one bf16 step (2^-7 relative): the two
    sides sum in different orders before the single rounding."""
    rng = np.random.default_rng(9)
    b, cq, hr, g, c, p, d = 1, 5, 2, 2, 4, 8, 16
    jc, tc = _paged_pair(rng, b, hr, c, p, d, (19,))
    q = _np(rng, b, cq, hr * g, d)
    kn, vn = _np(rng, b, cq, hr, d), _np(rng, b, cq, hr, d)
    st = np.asarray([19], np.int32)
    jk, jv = jc.k_pages.astype(jnp.bfloat16), jc.v_pages.astype(jnp.bfloat16)
    want = jops.chunk_attention_paged(
        jnp.asarray(q).astype(jnp.bfloat16), jk, jv, jc.page_start, jnp.asarray(st),
        jnp.asarray(kn), jnp.asarray(vn), impl="ref")
    got = ops.chunk_attention_paged(
        _t(q).bfloat16(), tc.k_pages.bfloat16(), tc.v_pages.bfloat16(), tc.page_start,
        _t(st), _t(kn), _t(vn))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-5)
    f32 = ops.chunk_attention_paged(
        _t(q).bfloat16(), tc.k_pages.bfloat16(), tc.v_pages.bfloat16(), tc.page_start,
        _t(st), _t(kn).bfloat16(), _t(vn).bfloat16())
    assert torch.equal(got, f32)


# ---------------------------------------------------------------------------
# ragged and chunk appends
# ---------------------------------------------------------------------------


def test_ragged_single_token_appends_match_jax():
    rng = np.random.default_rng(11)
    b, h, d, sink, cap = 3, 2, 16, 2, 24
    length = np.asarray([5, 30, 17], np.int32)
    active = np.asarray([True, False, True])
    jp, tp = _paged_pair(rng, b, h, 7, 8, d, length)
    kn, vn = _np(rng, b, h, d), _np(rng, b, h, d)
    jp = jcache.paged_cache_append(jp, jnp.asarray(kn), jnp.asarray(vn),
                                   jnp.asarray(length), active=jnp.asarray(active))
    tp = tcache.paged_cache_append(tp, _t(kn), _t(vn), _t(length), _t(active))
    _same_paged(tp, jp)

    k = _np(rng, b, 40, h, d)
    js = jcache.stream_cache_from_prefill(jnp.asarray(k), jnp.asarray(k), sink=sink,
                                          local_cap=cap, length=40)
    ts = tcache.stream_cache_from_prefill(_t(k), _t(k), sink=sink, local_cap=cap,
                                          length=40)
    for step in range(3):
        ln = np.asarray([40 + step, 41 + 2 * step, 40], np.int32)
        js = jcache.stream_cache_append(js, jnp.asarray(kn), jnp.asarray(vn),
                                        jnp.asarray(ln), sink=sink,
                                        active=jnp.asarray(active))
        ts = tcache.stream_cache_append(ts, _t(kn), _t(vn), _t(ln), sink=sink,
                                        active=_t(active))
    _same_stream(ts, js)

    full = _np(rng, b, h, 12, d)
    jf = jcache.full_cache_append(jcache.FullCache(jnp.asarray(full), jnp.asarray(full)),
                                  jnp.asarray(kn), jnp.asarray(vn),
                                  jnp.asarray([3, 11, 0], np.int32),
                                  active=jnp.asarray(active))
    tf = tcache.full_cache_append(tcache.FullCache(_t(full), _t(full)), _t(kn), _t(vn),
                                  _t(np.asarray([3, 11, 0], np.int32)), _t(active))
    _close(tf.k, jf.k)
    _close(tf.v, jf.v)


@pytest.mark.parametrize("chunk", [3, 8, 29])
def test_chunk_appends_match_jax(chunk):
    """Paged, stream and full chunk appends over a few steps with ragged
    starts and lengths, an inactive slot, chunks that straddle pages and a
    chunk longer than the ring."""
    rng = np.random.default_rng(chunk)
    b, h, d, p, c, sink, cap = 3, 2, 16, 8, 9, 2, 12
    active = np.asarray([True, True, False])
    start = np.asarray([0, 5, 13], np.int32)
    jp, tp = _paged_pair(rng, b, h, c, p, d, start)  # empty past start
    js = jcache.make_stream_cache(b, h, sink, cap, d, dtype=jnp.float32)
    ts = tcache.make_stream_cache(b, h, sink, cap, d, dtype=torch.float32, device="cpu")
    jf = jcache.make_full_cache(b, h, c * p, d, dtype=jnp.float32)
    tf = tcache.make_full_cache(b, h, c * p, d, dtype=torch.float32, device="cpu")
    for _ in range(3):
        clen = np.minimum(rng.integers(0, chunk + 1, b), c * p - 1 - start).astype(np.int32)
        kn, vn = _np(rng, b, chunk, h, d), _np(rng, b, chunk, h, d)
        ja = (jnp.asarray(start), jnp.asarray(clen))
        ta = (_t(start), _t(clen))
        jp = jcache.paged_cache_append_chunk(jp, jnp.asarray(kn), jnp.asarray(vn), *ja,
                                             active=jnp.asarray(active))
        tp = tcache.paged_cache_append_chunk(tp, _t(kn), _t(vn), *ta, active=_t(active))
        js = jcache.stream_cache_append_chunk(js, jnp.asarray(kn), jnp.asarray(vn), *ja,
                                              sink=sink, active=jnp.asarray(active))
        ts = tcache.stream_cache_append_chunk(ts, _t(kn), _t(vn), *ta, sink=sink,
                                              active=_t(active))
        jf = jcache.full_cache_append_chunk(jf, jnp.asarray(kn), jnp.asarray(vn), *ja,
                                            active=jnp.asarray(active))
        tf = tcache.full_cache_append_chunk(tf, _t(kn), _t(vn), *ta, _t(active))
        start = np.where(active, start + clen, start).astype(np.int32)
    _same_paged(tp, jp)
    _same_stream(ts, js)
    _close(tf.k, jf.k)
    _close(tf.v, jf.v)


def test_empty_fill_values_match_jax():
    for field in ("k_pages", "tau_min", "tau_max", "importance", "page_start",
                  "sel_idx", "pos", "k"):
        want = jcache.empty_fill_value(f"['layers'].{field}")
        assert tcache.empty_fill_value(field) == want, field


# ---------------------------------------------------------------------------
# paging helpers
# ---------------------------------------------------------------------------


def test_chunk_validity_helpers_match_jax():
    rng = np.random.default_rng(3)
    b, h, c, p, cq = 2, 2, 6, 8, 5
    ps = np.where(rng.random((b, h, c)) < 0.7, np.arange(c) * p, -1).astype(np.int32)
    start = np.asarray([3, 30], np.int32)
    jpos_q = jpaging.chunk_positions(jnp.asarray(start), cq)
    tpos_q = tpaging.chunk_positions(_t(start), cq)
    _eq(tpos_q, jpos_q)
    jkp, jko = jpaging.paged_key_positions(jnp.asarray(ps), p)
    tkp, tko = tpaging.paged_key_positions(_t(ps), p)
    _eq(tkp, jkp)
    _eq(tko, jko)
    _eq(tpaging.chunk_causal_validity(tkp, tko, tpos_q),
        jpaging.chunk_causal_validity(jkp, jko, jpos_q))
    _eq(tpaging.chunk_stream_validity(tkp, tpos_q, sink=2, local=9),
        jpaging.chunk_stream_validity(jkp, jpos_q, sink=2, local=9))


def test_ragged_selection_matches_through_token_validity():
    """Per-slot contexts, each with its own first local page."""
    rng = np.random.default_rng(4)
    b, h, g, d, p, c, top_k = 3, 2, 2, 16, 8, 13, 4
    kw = dict(sink=2, local=16, page=p)
    ctx = np.asarray([20, 57, 100], np.int32)
    jp, tp = _paged_pair(rng, b, h, c, p, d, ctx)
    q = _np(rng, b, h * g, d)
    js = jpaging.score_pages(jnp.asarray(q), jp.tau_min, jp.tau_max, jp.page_start,
                             jnp.asarray(ctx), **kw)
    ts = tpaging.score_pages(_t(q), tp.tau_min, tp.tau_max, tp.page_start, _t(ctx),
                             **kw)
    _close(ts, js)
    jslots = jpaging.attended_page_slots(jpaging.select_pages(js, top_k),
                                         jnp.asarray(ctx), **kw)
    tslots = tpaging.attended_page_slots(tpaging.select_pages(ts, top_k), _t(ctx), **kw)
    jv = np.asarray(jpaging.token_validity(jslots, jp.page_start, jnp.asarray(ctx),
                                           top_k=top_k, **kw))
    tv = tpaging.token_validity(tslots, tp.page_start, _t(ctx), top_k=top_k,
                                **kw).numpy()
    jtok = (np.asarray(jslots)[..., None] * p + np.arange(p)).reshape(b, h, -1)
    ttok = (tslots.numpy()[..., None] * p + np.arange(p)).reshape(b, h, -1)
    for bi in range(b):
        for hi in range(h):
            _eq(np.sort(ttok[bi, hi][tv[bi, hi]]), np.sort(jtok[bi, hi][jv[bi, hi]]))


def test_chunk_allocation_matches_jax_fifo():
    rng = np.random.default_rng(5)
    for _ in range(50):
        n = int(rng.integers(1, 5))
        done = rng.integers(0, 40, n).tolist()
        left = rng.integers(0, 30, n).tolist()
        budget, page = int(rng.integers(1, 40)), int(rng.choice([4, 8, 32]))
        want = jbalance.chunk_allocation(done, left, budget, n_shards=1,
                                         page_size=page)
        assert tbalance.chunk_allocation(done, left, budget, n_shards=1,
                                         page_size=page) == want


# ---------------------------------------------------------------------------
# attention bodies
# ---------------------------------------------------------------------------


def _decode_states(rng, jspec, tspec, s_max, b, cap, perm):
    k, v = _np(rng, b, s_max, 4, 16), _np(rng, b, s_max, 4, 16)
    jp, js = jhattn.init_decode_state(jspec, jnp.asarray(k), jnp.asarray(v), s_max,
                                      cap, jnp.asarray(perm))
    tp, ts = thattn.init_decode_state(tspec, _t(k), _t(v), s_max, cap, _t(perm))
    return jp, js, tp, ts


@pytest.mark.parametrize("chunk", [4, 11])
def test_chunk_prefill_attention_matches_jax(chunk):
    """Several chunk steps into reset slots with ragged starts, an inactive
    slot and a random head permutation: outputs of the valid rows and the
    caches agree after every step."""
    rng = np.random.default_rng(chunk)
    jspec, tspec = _specs()
    b, cap = 3, 64
    perm = rng.permutation(4).astype(np.int32)
    jp, js, tp, ts = _decode_states(rng, jspec, tspec, 8, b, cap, perm)
    for i in range(b):  # reset every slot to the empty values
        jp = jax.tree.map(lambda a, f: a.at[i].set(f), jp, jcache.PagedCache(
            *(jcache.empty_fill_value(n) for n in
              ("k_pages", "v_pages", "tau_min", "tau_max", "importance",
               "page_start", "sel_idx"))))
        js = jax.tree.map(lambda a, f: a.at[i].set(f), js, jcache.StreamCache(
            *(jcache.empty_fill_value(n) for n in ("k", "v", ".pos"))))
        for c_ in (tp, ts):
            for name in c_.__dataclass_fields__:
                getattr(c_, name)[i].fill_(tcache.empty_fill_value(name))
    start = np.asarray([0, 0, 0], np.int32)
    active = np.asarray([True, True, False])
    jstep = jax.jit(functools.partial(jhattn.chunk_prefill_attention, jspec))
    for _ in range(4):
        clen = rng.integers(1, chunk + 1, b).astype(np.int32)
        q = _np(rng, b, chunk, 8, 16)
        kn, vn = _np(rng, b, chunk, 4, 16), _np(rng, b, chunk, 4, 16)
        jo, jp, js = jstep(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jp, js,
            jnp.asarray(start), jnp.asarray(clen), jnp.asarray(active),
            perm=jnp.asarray(perm))
        to, tp, ts = thattn.chunk_prefill_attention(
            tspec, _t(q), _t(kn), _t(vn), tp, ts, _t(start), _t(clen), _t(active),
            perm=_t(perm))
        for i in np.nonzero(active)[0]:
            _close(to[i, : clen[i]], np.asarray(jo)[i, : clen[i]])
        _same_paged(tp, jp)
        _same_stream(ts, js)
        start = np.where(active, start + clen, start).astype(np.int32)


def test_ragged_decode_attention_matches_jax():
    """Ragged lengths, an inactive slot and per-slot need_select over
    select and reuse steps: outputs of the active slots, caches and the
    attended token sets agree after every step."""
    rng = np.random.default_rng(7)
    jspec, tspec = _specs(select_budget=16)
    b, s, cap = 3, 45, 72
    perm = rng.permutation(4).astype(np.int32)
    jp, js, tp, ts = _decode_states(rng, jspec, tspec, s, b, cap, perm)
    length = np.asarray([45, 30, 41], np.int32)  # slots hold fewer tokens
    active = np.asarray([True, False, True])
    h2 = tspec.h2
    kw = dict(sink=h2.sink, local=h2.local, page=h2.page_size)
    jsteps = [jax.jit(functools.partial(jhattn.decode_attention, jspec, do_select=sel))
              for sel in (False, True)]
    for i in range(6):
        q, kn, vn = _np(rng, b, 8, 16), _np(rng, b, 4, 16), _np(rng, b, 4, 16)
        sel = i % 2 == 0
        need = active & (np.asarray([True, i % 4 == 0, False]) | (i == 0))
        extra = dict(need_select=need) if sel else {}
        jo, jp, js = jsteps[sel](
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jp, js,
            jnp.asarray(length), perm=jnp.asarray(perm),
            active=jnp.asarray(active),
            **{k_: jnp.asarray(v_) for k_, v_ in extra.items()})
        to, tp, ts = thattn.decode_attention(
            tspec, _t(q), _t(kn), _t(vn), tp, ts, _t(length), do_select=sel,
            perm=_t(perm), active=_t(active),
            **{k_: _t(v_) for k_, v_ in extra.items()})
        for bi in np.nonzero(active)[0]:
            _close(to[bi], np.asarray(jo)[bi])
        for f in ("k_pages", "v_pages", "tau_min", "tau_max", "importance"):
            _close(getattr(tp, f), getattr(jp, f), 1e-4)
        _eq(tp.page_start, jp.page_start)
        _same_stream(ts, js)
        ctx = length + 1
        jv = np.asarray(jpaging.token_validity(
            jpaging.attended_page_slots(jp.sel_idx, jnp.asarray(ctx), **kw),
            jp.page_start, jnp.asarray(ctx), top_k=h2.top_k_pages, **kw))
        tslots = tpaging.attended_page_slots(tp.sel_idx, _t(ctx), **kw)
        tv = tpaging.token_validity(tslots, tp.page_start, _t(ctx),
                                    top_k=h2.top_k_pages, **kw).numpy()
        jslots = np.asarray(jpaging.attended_page_slots(jp.sel_idx, jnp.asarray(ctx),
                                                        **kw))
        p = h2.page_size
        for bi in np.nonzero(active)[0]:
            for hi in range(tp.sel_idx.shape[1]):
                jt = (jslots[bi, hi][:, None] * p + np.arange(p)).ravel()[jv[bi, hi]]
                tt = (tslots[bi, hi].numpy()[:, None] * p + np.arange(p)).ravel()[tv[bi, hi]]
                _eq(np.sort(tt), np.sort(jt))
        length = np.where(active, length + 1, length).astype(np.int32)


def test_ragged_full_decode_attention_matches_jax():
    rng = np.random.default_rng(8)
    jspec, tspec = _specs(enabled=False)
    k = _np(rng, 3, 4, 30, 16)
    jc = jcache.FullCache(k=jnp.asarray(k), v=jnp.asarray(k[::-1]))
    tc = tcache.FullCache(k=_t(k), v=_t(k[::-1]))
    length = np.asarray([11, 3, 25], np.int32)
    active = np.asarray([True, True, False])
    for _ in range(3):
        q, kn, vn = _np(rng, 3, 8, 16), _np(rng, 3, 4, 16), _np(rng, 3, 4, 16)
        jo, jc = jhattn.full_decode_attention(jspec, jnp.asarray(q), jnp.asarray(kn),
                                              jnp.asarray(vn), jc, jnp.asarray(length),
                                              active=jnp.asarray(active))
        to, tc = thattn.full_decode_attention(tspec, _t(q), _t(kn), _t(vn), tc,
                                              _t(length), _t(active))
        _close(to[:2], np.asarray(jo)[:2])
        _close(tc.k, jc.k)
        length = np.where(active, length + 1, length).astype(np.int32)


# ---------------------------------------------------------------------------
# the model's chunked prefill
# ---------------------------------------------------------------------------


def _jax_empty_state(cfg, params, b, capacity):
    scfg = jserve.ServeConfig(capacity=capacity)
    probe = jax.ShapeDtypeStruct((b, 8), jnp.int32)
    shapes = jax.eval_shape(jserve.make_prefill(cfg, scfg), params, probe)[1]
    state = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    state["length"] = jnp.zeros((b,), jnp.int32)
    return state


@pytest.mark.parametrize("name", ["smollm-360m", "llama3-8b"])
def test_prefill_chunk_matches_jax(name):
    """Two slots fed prompts of different lengths chunk by chunk (one slot
    idle for a step): the logits of every slot's last valid position agree
    with JAX's after the whole layer stack."""
    jcfg = jconfigs.reduced(jconfigs.get_arch(name))
    tcfg = tconfigs.reduced(tconfigs.get_arch(name))
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(tcfg, jax.tree.map(np.asarray, jparams), "cpu")
    cap, chunk = 64, 7
    jstate = _jax_empty_state(jcfg, jparams, 2, cap)
    tstate = TM.empty_serve_state(tcfg, 2, capacity=cap, dtype=torch.float32,
                                  device="cpu")
    for i in range(2):
        jstate = j_reset_slot(jstate, jnp.int32(i))
        t_reset_slot(tstate, i)
    scfg = jserve.ServeConfig(capacity=cap)
    jstep = jax.jit(jserve.make_prefill_chunk_step(jcfg, scfg, chunk=chunk))
    rng = np.random.default_rng(1)
    plan = [(np.asarray([7, 3]), np.asarray([True, True])),
            (np.asarray([5, 0]), np.asarray([True, False])),
            (np.asarray([7, 6]), np.asarray([True, True]))]
    for clen, act in plan:
        toks = rng.integers(0, jcfg.vocab_size, (2, chunk)).astype(np.int32)
        clen = clen.astype(np.int32)
        jl, jstate = jstep(jparams, jstate, jnp.asarray(toks), jnp.asarray(clen),
                           jnp.asarray(act))
        tl, tstate = TM.prefill_chunk(tcfg, tparams, tstate, _t(toks),
                                      chunk_len=_t(clen), active=_t(act))
        _eq(tstate["length"], jstate["length"])
        for i in np.nonzero(act)[0]:
            _close(tl[i], np.asarray(jl)[i], LOGIT_TOL)

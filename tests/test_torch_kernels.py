"""PyTorch port, kernels: the plain versions against the JAX reference on
the CPU, and the dispatch rules. The hand-written kernels themselves are
held against the plain versions on a card in tests/test_torch_cuda.py.

Tolerance: 2e-5 in f32 (the two sides sum in different orders).
"""
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import H2ealConfig as JH2
from repro.core import hybrid_attention as jhattn
from repro.core import paging as jpaging
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs.base import H2ealConfig as TH2
from repro_torch.core import hybrid_attention as thattn
from repro_torch.core import paging as tpaging
from repro_torch.kernels import ops, ref as tref
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

TOL = 2e-5


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


FLASH_CASES = [
    # (b, sq, sk, hq, hkv, d, causal, window, sink, q_offset)
    (2, 24, 24, 4, 4, 16, True, 0, 0, 0),      # causal, group 1
    (2, 24, 24, 4, 2, 16, True, 0, 0, 0),      # group 2
    (1, 33, 33, 8, 2, 32, True, 8, 2, 0),      # window + sink, group 4
    (1, 16, 40, 4, 2, 16, True, 0, 0, 24),     # q_offset, Sq != Sk
    (1, 16, 40, 4, 1, 16, True, 6, 3, 24),     # window + sink + offset
    (1, 12, 20, 2, 1, 16, False, 0, 0, 0),     # not causal
    (1, 12, 20, 2, 1, 16, True, 4, 0, 16),     # rows past Sk: fully masked
]


# the JAX references, jitted: one compile a shape of the whole function,
# where eager dispatch compiles each of its operations a shape
j_flash = jax.jit(jref.flash_attention_ref, static_argnames=("causal", "window", "sink",
                                                             "q_offset"))
j_paged = jax.jit(jref.paged_attention_ref)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_jax(case):
    b, sq, sk, hq, hkv, d, causal, window, sink, off = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = _np(rng, b, sq, hq, d), _np(rng, b, sk, hkv, d), _np(rng, b, sk, hkv, d)
    kw = dict(causal=causal, window=window, sink=sink, q_offset=off)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), **kw)
    assert got.shape == (b, sq, hq, d) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_paged_attention_plain_matches_jax(group):
    rng = np.random.default_rng(group)
    b, hkv, t, d = 3, 2, 37, 16
    q = _np(rng, b, hkv * group, d)
    k, v = _np(rng, b, hkv, t, d), _np(rng, b, hkv, t, d)
    valid = rng.random((b, hkv, t)) < 0.6
    valid[1, 0] = False  # an all-invalid row gives 0
    want = j_paged(*(jnp.asarray(x) for x in (q, k, v, valid)))
    got = ops.paged_attention(*(torch.from_numpy(x) for x in (q, k, v, valid)))
    _close(got, want)
    assert float(got[1, :group].abs().max()) == 0.0


@pytest.mark.parametrize("group", [1, 4, 8])
def test_paged_attention_pages_plain_matches_jax_gather_then_attention(group):
    """Decode attention read through a page table equals JAX's gather_pages
    followed by its paged_attention (impl="ref"): slots hold sentinels (-1)
    and slots past the cache, which the port clamps into [0, C) (JAX's
    gather fills NaN past C, so it is handed the clamped list), and one row
    has no valid token (its output is 0). Tolerance 1e-5 in f32."""
    rng = np.random.default_rng(20 + group)
    b, hkv, c, p, n, d = 2, 2, 7, 4, 6, 16
    q = _np(rng, b, hkv * group, d)
    kp, vp = _np(rng, b, hkv, c, p, d), _np(rng, b, hkv, c, p, d)
    slots = rng.integers(0, c, (b, hkv, n)).astype(np.int32)
    slots[0, 0, 1], slots[0, 1, 5], slots[1, 1, 4] = -1, c, c + 2
    valid = rng.random((b, hkv, n * p)) < 0.7
    valid[0, 1, 5 * p:] = False   # a page past the cache, masked as token_validity does
    valid[1, 0] = False           # a row with no valid token
    jk, jv = jpaging.gather_pages(jnp.asarray(kp), jnp.asarray(vp),
                                  jnp.asarray(np.clip(slots, 0, c - 1)))
    want = jops.paged_attention(jnp.asarray(q), jk, jv, jnp.asarray(valid), impl="ref")
    got = ops.paged_attention_pages(*(torch.from_numpy(x) for x in (q, kp, vp, slots, valid)))
    assert got.shape == (b, hkv * group, d) and got.dtype == torch.float32
    _close(got, want, tol=1e-5)
    assert float(got[1, :group].abs().max()) == 0.0


def test_paged_decode_reads_pages_in_place(monkeypatch):
    """The retrieval heads' decode attends the pages where they lie: a
    select step and a reuse step each hand the cache's own page tensors to
    one ``paged_attention_pages`` call, the only gather on the path is that
    call's plain version (on the card the kernel reads the pages through the
    slots), and their outputs match JAX's decode_attention."""
    calls, gathers = [], []
    fused, gather = ops.paged_attention_pages, tref.gather_pages

    def recording(q, k_pages, v_pages, slots, valid):
        calls.append((k_pages, v_pages))
        return fused(q, k_pages, v_pages, slots, valid)

    def counting(*args):
        gathers.append(len(calls))
        return gather(*args)

    monkeypatch.setattr(ops, "paged_attention_pages", recording)
    monkeypatch.setattr(tref, "gather_pages", counting)
    rng = np.random.default_rng(8)
    h2 = dict(sink=2, local=16, page_size=8, select_budget=16, share_window=2)
    jspec = jhattn.AttnSpec(n_q=8, n_kv=4, head_dim=16, h2=JH2(**h2))
    tspec = thattn.AttnSpec(n_q=8, n_kv=4, head_dim=16, h2=TH2(**h2))
    s, cap = 45, 64
    k, v = _np(rng, 2, s, 4, 16), _np(rng, 2, s, 4, 16)
    jp, js = jhattn.init_decode_state(jspec, jnp.asarray(k), jnp.asarray(v), s, cap)
    tp, ts = thattn.init_decode_state(tspec, torch.from_numpy(k), torch.from_numpy(v), s, cap)
    for i, sel in enumerate((True, False)):
        q, kn, vn = _np(rng, 2, 8, 16), _np(rng, 2, 4, 16), _np(rng, 2, 4, 16)
        jo, jp, js = jax.jit(functools.partial(jhattn.decode_attention, jspec,
                                               do_select=sel))(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jp, js, jnp.int32(s + i))
        to, tp, ts = thattn.decode_attention(
            tspec, *(torch.from_numpy(x) for x in (q, kn, vn)), tp, ts, s + i,
            do_select=sel)
        _close(to, jo)
        assert len(calls) == i + 1
        assert calls[i][0] is tp.k_pages and calls[i][1] is tp.v_pages
        assert gathers == list(range(1, i + 2))  # one, inside each call


@pytest.mark.parametrize("group", [1, 2, 4])
def test_page_score_plain_matches_jax(group):
    rng = np.random.default_rng(10 + group)
    b, hkv, c, d = 2, 2, 9, 16
    q = _np(rng, b, hkv * group, d)
    lo, hi = _np(rng, b, hkv, c, d), _np(rng, b, hkv, c, d)
    tmin, tmax = np.minimum(lo, hi), np.maximum(lo, hi)
    want = jref.page_score_ref(jnp.asarray(q), jnp.asarray(tmin), jnp.asarray(tmax))
    got = ops.page_score(torch.from_numpy(q), torch.from_numpy(tmin),
                         torch.from_numpy(tmax))
    assert got.dtype == torch.float32
    _close(got, want)


def test_empty_pages_through_score_pages():
    """Empty pages hold τ = ±inf: the raw score is NaN on both sides and
    score_pages masks it to NEG_INF, like sink and local pages."""
    rng = np.random.default_rng(3)
    b, hkv, g, c, p, d = 2, 2, 2, 12, 4, 16
    q = _np(rng, b, hkv * g, d)
    lo, hi = _np(rng, b, hkv, c, d), _np(rng, b, hkv, c, d)
    tmin, tmax = np.minimum(lo, hi), np.maximum(lo, hi)
    filled = 9
    tmin[:, :, filled:], tmax[:, :, filled:] = np.inf, -np.inf
    start = np.where(np.arange(c) < filled, np.arange(c) * p, -1).astype(np.int32)
    start = np.broadcast_to(start, (b, hkv, c)).copy()
    raw_j = np.asarray(jref.page_score_ref(jnp.asarray(q), jnp.asarray(tmin), jnp.asarray(tmax)))
    raw_t = tref.page_score_ref(torch.from_numpy(q), torch.from_numpy(tmin),
                                torch.from_numpy(tmax)).numpy()
    np.testing.assert_array_equal(np.isnan(raw_t), np.isnan(raw_j))
    assert np.isnan(raw_t[..., filled:]).all()
    kw = dict(sink=4, local=8, page=p)
    ctx = filled * p - 1
    want = jpaging.score_pages(jnp.asarray(q), jnp.asarray(tmin), jnp.asarray(tmax),
                               jnp.asarray(start), ctx, **kw)
    got = tpaging.score_pages(torch.from_numpy(q), torch.from_numpy(tmin),
                              torch.from_numpy(tmax), torch.from_numpy(start), ctx, **kw)
    assert not torch.isnan(got).any()
    _close(got, want)


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    ops.reset_launches()
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_np(rng, 1, 8, 2, 16))
    k = torch.from_numpy(_np(rng, 1, 8, 1, 16))
    torch.testing.assert_close(ops.flash_attention(q, k, k),
                               tref.flash_attention_ref(q, k, k), rtol=0, atol=0)
    o, lse = ops.flash_attention_lse(q, k, k)
    torch.testing.assert_close(o, tref.flash_attention_ref(q, k, k), rtol=0, atol=0)
    torch.testing.assert_close(lse, tref.flash_attention_lse_ref(q, k), rtol=0, atol=0)
    for got, want in zip(ops.flash_attention_bwd(q, k, k, o, q, lse),
                         tref.flash_attention_bwd_ref(q, k, k, o, q)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert ops.LAUNCHES == {"flash_attention": 0, "page_score": 0,
                            "paged_attention": 0, "chunk_attention": 0,
                            "chunk_attention_paged": 0,
                            "paged_attention_partial": 0, "combine_partials": 0,
                            "flash_attention_bwd": 0}


def test_mixed_devices_raise():
    q = torch.zeros(1, 2, 16)
    meta = torch.zeros(1, 1, 3, 16, device="meta")
    with pytest.raises(ValueError, match="expected all on the CPU"):
        ops.page_score(q, meta, meta)


def test_ops_import_needs_neither_nvcc_nor_cuda(tmp_path):
    """Importing the port builds nothing and needs no card: the kernels are
    built at their first launch."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys, repro_torch.kernels.ops, repro_torch.launch.serve; "
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules; "
            "print('imported')")
    env = {"PATH": str(tmp_path), "PYTHONPATH": str(src), "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout
    assert not (Path(ops.__file__).parent / "build").exists() or torch.cuda.is_available()

"""PyTorch port, kernels: the plain versions against the JAX reference on
the CPU, and the dispatch rules. The hand-written kernels themselves are
held against the plain versions on a card in tests/test_torch_cuda.py.

Tolerance: 2e-5 in f32 (the two sides sum in different orders).
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paging as jpaging
from repro.kernels import ref as jref
from repro_torch.core import paging as tpaging
from repro_torch.kernels import ops, ref as tref

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


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_jax(case):
    b, sq, sk, hq, hkv, d, causal, window, sink, off = case
    rng = np.random.default_rng(sum(case[:6]))
    q, k, v = _np(rng, b, sq, hq, d), _np(rng, b, sk, hkv, d), _np(rng, b, sk, hkv, d)
    kw = dict(causal=causal, window=window, sink=sink, q_offset=off)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
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
    want = jref.paged_attention_ref(*(jnp.asarray(x) for x in (q, k, v, valid)))
    got = ops.paged_attention(*(torch.from_numpy(x) for x in (q, k, v, valid)))
    _close(got, want)
    assert float(got[1, :group].abs().max()) == 0.0


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
    assert ops.LAUNCHES == {"flash_attention": 0, "page_score": 0,
                            "paged_attention": 0, "chunk_attention": 0,
                            "chunk_attention_paged": 0,
                            "paged_attention_partial": 0, "combine_partials": 0}


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

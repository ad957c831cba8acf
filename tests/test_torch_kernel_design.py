"""PyTorch port, the arithmetic of the Hopper kernels' designs, on the CPU.

The card kernels themselves run only on a card (tests/test_torch_cuda.py).
Here plain-torch emulations of what they compute are held against the port's
plain versions and the JAX reference:

  * paged_attention: the split count (``ops.paged_splits``), and the
    split-KV grid's arithmetic: ``paged_attention_partial_ref`` over each
    split's key range, merged by ``combine_partials_ref``, equals
    ``paged_attention_ref`` within the f32 tolerance of 2e-5 (the two sum in
    different orders), splits with no valid key included;
  * the bf16 flash_attention kernel: an online softmax over key tiles of 128
    that rounds the unnormalised P to bf16 before P·V stays within
    |emulated - plain| <= 2^-8·(softmax(s)·|V|) + 2^-8·|plain| + 1e-5 of
    the plain version on widened inputs: each p lies in [0, 1], so its
    rounding moves the output by at most 2^-8·Σ p|v| / l, and the output's
    own rounding by 2^-8 of the value.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref as tref

TOL = 2e-5
SPLIT_BLOCKS = 2 * 132  # two blocks on each of the H100's SMs
BK = 128                # the bf16 flash kernel's key tile


# ---------------------------------------------------------------------------
# paged_attention: split count and split-and-merge
# ---------------------------------------------------------------------------


@settings(deadline=None, max_examples=300)
@given(b=st.integers(1, 96), hkv=st.integers(1, 16), t=st.integers(1, 40000))
def test_paged_splits_fill_the_card_and_keep_128_keys_a_split(b, hkv, t):
    n = ops.paged_splits(b, hkv, t)
    want = -(-SPLIT_BLOCKS // (b * hkv))
    assert n >= 1
    if b * hkv >= SPLIT_BLOCKS:
        assert n == 1
    if n > 1:
        assert -(-t // n) >= 128          # a split holds >= 128 keys
        assert b * hkv * (n - 1) < SPLIT_BLOCKS  # no more splits than needed
    if t // 128 >= want:
        assert b * hkv * n >= SPLIT_BLOCKS  # fills two blocks a SM where it can
    else:
        assert n == max(1, t // 128)        # else as many as 128 keys allow


def test_paged_splits_at_the_serving_shapes():
    """llama3-8b decode at B=2: retrieval heads (4 kv heads, 4416 tokens),
    streaming heads (4 kv heads, 292 slots), full attention (8, 8256)."""
    assert ops.paged_splits(2, 4, 4416) == 33
    assert ops.paged_splits(2, 4, 292) == 2
    assert ops.paged_splits(2, 8, 8256) == 17
    assert ops.paged_splits(70, 4, 600) == 1


def split_merge(q, k, v, valid):
    """The split-KV grid in plain torch: a partial per split's key range
    (the identity (NEG_INF, 0, 0) where the range is empty), merged."""
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    n = ops.paged_splits(b, hkv, t)
    chunk = -(-t // n)
    ms, ls, os_ = [], [], []
    for s in range(n):
        lo, hi = s * chunk, min(t, (s + 1) * chunk)
        if lo >= hi:
            ms.append(torch.full((b, hq), tref.NEG_INF))
            ls.append(torch.zeros(b, hq))
            os_.append(torch.zeros(b, hq, d))
            continue
        m, l, o = tref.paged_attention_partial_ref(q, k[:, :, lo:hi], v[:, :, lo:hi],
                                                   valid[:, :, lo:hi])
        ms.append(m), ls.append(l), os_.append(o)
    return n, tref.combine_partials_ref(torch.stack(ms), torch.stack(ls),
                                        torch.stack(os_)).to(q.dtype)


# (b, hkv, t, group, d): one split; a ragged last split; two splits (B·Hkv
# under 264); one split a stream (B·Hkv >= 264); 33 splits of 134 keys; and
# 264 splits whose last one is empty (t = 33892: 263 splits of 129 cover it)
SPLIT_CASES = [(1, 2, 100, 4, 32), (2, 3, 1000, 3, 64), (40, 4, 300, 2, 32),
               (70, 4, 600, 4, 32), (2, 4, 4416, 4, 64), (1, 1, 33892, 2, 32)]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_and_merge_equals_paged_attention(case):
    b, hkv, t, group, d = case
    rng = np.random.default_rng(t)
    q = rng.standard_normal((b, hkv * group, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    valid = rng.random((b, hkv, t)) < 0.8
    n = ops.paged_splits(b, hkv, t)
    chunk = -(-t // n)
    if n > 1:
        valid[0, 0, chunk:2 * chunk] = False   # a split with no valid key
    valid[-1, -1] = False                      # an all-invalid row
    tq, tk, tv, tvl = (torch.from_numpy(x) for x in (q, k, v, valid))
    n_got, got = split_merge(tq, tk, tv, tvl)
    assert n_got == n
    want = tref.paged_attention_ref(tq, tk, tv, tvl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    assert got[-1, -group:].abs().max().item() == 0.0
    jwant = jref.paged_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the bf16 flash kernel's numerics
# ---------------------------------------------------------------------------


def flash_emulated(q, k, v, *, causal=True, window=0, sink=0, q_offset=0, bk=BK):
    """What the bf16 flash kernel computes, in plain torch: f32 logits of
    the bf16 operands, an online softmax over key tiles of ``bk`` whose
    unnormalised P is rounded to bf16 before P·V (f32 sums), the division by
    max(l, 1e-30) last, bf16 output. q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.float().transpose(1, 2)                                  # (B, Hq, Sq, D)
    kf = k.float().repeat_interleave(g, dim=2).transpose(1, 2)      # (B, Hq, Sk, D)
    vf = v.float().repeat_interleave(g, dim=2).transpose(1, 2)
    scale = tref._scale(d)
    i = torch.arange(sq)[:, None] + q_offset
    m = torch.full((b, hq, sq, 1), float("-inf"))
    l = torch.zeros(b, hq, sq, 1)
    acc = torch.zeros(b, hq, sq, d)
    for c0 in range(0, sk, bk):
        j = torch.arange(c0, min(c0 + bk, sk))[None, :]
        ok = torch.ones(sq, j.shape[1], dtype=torch.bool)
        if causal:
            ok &= j <= i
        if window > 0:
            ok &= (j > i - window) | (j < sink)
        s = (qf @ kf[:, :, c0:c0 + bk].transpose(-1, -2)) * scale
        s = torch.where(ok, s, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        mu = torch.where(m_new == float("-inf"), 0.0, m_new)
        corr = torch.exp(m - mu)
        p = torch.exp(s - mu)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :, c0:c0 + bk]
        m = m_new
    out = acc / l.clamp(min=1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


def flash_excess(got, q, k, v, **kw) -> float:
    """Largest |got - plain| - (2^-8·softmax(s)·|V| + 2^-8·|plain| + 1e-5):
    within the bf16 flash tolerance at <= 0."""
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    p_term = tref.flash_attention_ref(q.float(), k.float(), v.float().abs(), **kw)
    bound = 2.0 ** -8 * p_term + 2.0 ** -8 * want.abs() + 1e-5
    return ((got.float() - want).abs() - bound).max().item()


def _bf16(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)
                            ).to(torch.bfloat16)


# (b, sq, sk, hq, hkv, d, causal, window, sink, q_offset): several key tiles,
# ragged ends, GQA groups, windows with sinks, an offset query block
EMU_CASES = [
    (1, 300, 300, 4, 1, 32, True, 0, 0, 0),
    (2, 200, 330, 4, 2, 64, True, 0, 0, 130),
    (1, 400, 400, 8, 1, 32, True, 150, 4, 0),
    (1, 130, 260, 2, 2, 32, False, 0, 0, 0),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", EMU_CASES)
def test_flash_bf16_numerics_within_the_derived_tolerance(case, seed):
    b, sq, sk, hq, hkv, d, causal, window, sink, off = case
    rng = np.random.default_rng(seed * 1000 + sq)
    q, k = _bf16(rng, b, sq, hq, d, scale=2.0), _bf16(rng, b, sk, hkv, d)
    v = _bf16(rng, b, sk, hkv, d)
    kw = dict(causal=causal, window=window, sink=sink, q_offset=off)
    got = flash_emulated(q, k, v, **kw)
    assert flash_excess(got, q, k, v, **kw) <= 0.0
    # the emulation is the JAX reference's attention up to that rounding
    jwant = jref.flash_attention_ref(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                     **kw)
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flash_bf16_numerics_near_zero_outputs(seed):
    """Values of random sign and large size over peaked logits: outputs near
    0 where Σ p|v| is large. The P-rounding term is what keeps these rows in
    tolerance; without it (2^-8·|plain| + 1e-5 alone) some row falls out."""
    rng = np.random.default_rng(seed)
    b, s, h, d = 1, 384, 2, 64
    q, k = _bf16(rng, b, s, h, d, scale=3.0), _bf16(rng, b, s, h, d)
    v = _bf16(rng, b, s, h, d, scale=8.0)
    got = flash_emulated(q, k, v, causal=True)
    assert flash_excess(got, q, k, v, causal=True) <= 0.0
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(), causal=True)
    old = ((got.float() - want).abs() - 2.0 ** -8 * want.abs() - 1e-5).max().item()
    assert old > 0.0

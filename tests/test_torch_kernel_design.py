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
    own rounding by 2^-8 of the value;
  * the bf16 chunk_attention and chunk_attention_paged kernels: q tiles of
    64 // g whole chunk positions, whose live 128-key tiles (the cache's,
    in physical page order, then the chunk's own) go in turns to two halves
    with their own online softmax, P rounded to bf16, the halves' (m, l, O)
    merged at the end: within the same derived bound.
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


# ---------------------------------------------------------------------------
# the bf16 chunk kernels' numerics
# ---------------------------------------------------------------------------

BQ = 64  # the bf16 chunk kernels' q tile: 64 // g whole chunk positions


def _online(half, s, v, ok):
    """One key tile of a half's online softmax: logits s (R, K) masked by ok
    (R, K), values v (K, D); P rounded to bf16 before P·V, f32 sums."""
    m, l, acc = half
    s = torch.where(ok, s, float("-inf"))
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    mu = torch.where(m_new == float("-inf"), 0.0, m_new)
    corr = torch.exp(m - mu)
    p = torch.exp(s - mu)
    return (m_new, l * corr + p.sum(dim=-1, keepdim=True),
            acc * corr + p.to(torch.bfloat16).float() @ v)


def _tile_attend(qr, items):
    """The rows qr (R, D) of a q tile over its live key tiles ``items`` [(k
    (K, D), v (K, D), ok (R, K))] in ring order: even items to one half,
    odd to the other, then the halves' (m, l, O) merged and divided by
    max(l, 1e-30)."""
    r, d = qr.shape
    halves = [(torch.full((r, 1), float("-inf")), torch.zeros(r, 1), torch.zeros(r, d))
              for _ in range(2)]
    for i, (k, v, ok) in enumerate(items):
        halves[i % 2] = _online(halves[i % 2], (qr @ k.T) * tref._scale(d), v, ok)
    (m0, l0, a0), (m1, l1, a1) = halves
    mt = torch.maximum(m0, m1)
    mu = torch.where(mt == float("-inf"), 0.0, mt)
    f0, f1 = torch.exp(m0 - mu), torch.exp(m1 - mu)
    return (a0 * f0 + a1 * f1) / (l0 * f0 + l1 * f1).clamp(min=1e-30)


def _q_tiles(q, bi, h, g):
    """(positions, rows (R, D) f32) of each q tile of (slot bi, kv head h):
    row r = c·g + gi is position c_lo + c of q head h·g + gi."""
    cq, d = q.shape[1], q.shape[3]
    for c_lo in range(0, cq, BQ // g):
        pos = torch.arange(c_lo, min(c_lo + BQ // g, cq))
        yield pos, q[bi, pos, h * g:(h + 1) * g].float().reshape(-1, d)


def chunk_emulated(q, k, v, valid):
    """What the bf16 chunk_attention kernel computes, in plain torch."""
    b, cq, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = hq // hkv
    out = torch.zeros(b, cq, hq, d)
    for bi in range(b):
        for h in range(hkv):
            kf, vf = k[bi, h].float(), v[bi, h].float()
            for pos, qr in _q_tiles(q, bi, h, g):
                ok = valid[bi, h, pos].repeat_interleave(g, dim=0)
                items = [(kf[t0:t0 + BK], vf[t0:t0 + BK], ok[:, t0:t0 + BK])
                         for t0 in range(0, t, BK) if ok[:, t0:t0 + BK].any()]
                out[bi, pos, h * g:(h + 1) * g] = _tile_attend(qr, items).reshape(-1, g, d)
    return out.to(torch.bfloat16)


def chunk_paged_emulated(q, kp, vp, page_start, start, kn, vn):
    """What the bf16 chunk_attention_paged kernel computes, in plain torch:
    the cache's live 128-key tiles in physical order (none at start 0),
    then the chunk's tiles up to the q tile's last position."""
    b, cq, hq, d = q.shape
    hr, c, p = kp.shape[1:4]
    g = hq // hr
    out = torch.zeros(b, cq, hq, d)
    for bi in range(b):
        st = int(start[bi])
        for h in range(hr):
            kc, vc = kp[bi, h].reshape(c * p, d).float(), vp[bi, h].reshape(c * p, d).float()
            ps = page_start[bi, h]
            key_pos = (ps[:, None] + torch.arange(p)).reshape(-1)
            key_ok = (ps >= 0).repeat_interleave(p) & (key_pos < st)
            cache = [(kc[t0:t0 + BK], vc[t0:t0 + BK], key_ok[t0:t0 + BK])
                     for t0 in range(0, c * p, BK) if st > 0 and key_ok[t0:t0 + BK].any()]
            knf, vnf = kn[bi, :, h].float(), vn[bi, :, h].float()
            for pos, qr in _q_tiles(q, bi, h, g):
                row_pos = pos.repeat_interleave(g)
                items = [(kt, vt, ok[None].expand(len(row_pos), -1)) for kt, vt, ok in cache]
                for j0 in range(0, int(pos[-1]) + 1, BK):
                    j = torch.arange(j0, min(j0 + BK, cq))
                    items.append((knf[j], vnf[j], j[None] <= row_pos[:, None]))
                out[bi, pos, h * g:(h + 1) * g] = _tile_attend(qr, items).reshape(-1, g, d)
    return out.to(torch.bfloat16)


def p_excess(got, want, p_term) -> float:
    """Largest |got - want| - (2^-8·p_term + 2^-8·|want| + 1e-5), p_term the
    plain version on |v|: within the bf16 tensor-core tolerance at <= 0."""
    bound = 2.0 ** -8 * p_term + 2.0 ** -8 * want.abs() + 1e-5
    return ((got.float() - want).abs() - bound).max().item()


# (b, cq, hkv, t, group): several key tiles, T % 4 != 0, group 3 (63-row q
# tiles), a ragged last q tile
CHUNK_EMU_CASES = [(2, 40, 2, 300, 3), (1, 33, 1, 261, 4), (1, 70, 1, 140, 1)]


@pytest.mark.parametrize("case", CHUNK_EMU_CASES)
def test_chunk_bf16_numerics_within_the_derived_tolerance(case):
    b, cq, hkv, t, g = case
    rng = np.random.default_rng(t)
    q, k = _bf16(rng, b, cq, hkv * g, 32, scale=2.0), _bf16(rng, b, hkv, t, 32)
    v = _bf16(rng, b, hkv, t, 32, scale=4.0)
    # a streaming head's mask: sink 4 and a window of 60 before each position
    pos_q = np.arange(cq)[:, None] + t - cq
    j = np.arange(t)[None, :]
    valid = (j <= pos_q) & ((j < 4) | (j > pos_q - 60)) & (rng.random((b, hkv, cq, t)) < 0.9)
    valid[-1, -1, 0] = False                     # an all-invalid row gives 0
    tvalid = torch.from_numpy(valid)
    got = chunk_emulated(q, k, v, tvalid)
    assert got[-1, 0, -g:].abs().max().item() == 0.0
    want = tref.chunk_attention_ref(q.float(), k.float(), v.float(), tvalid)
    p_term = tref.chunk_attention_ref(q.float(), k.float(), v.float().abs(), tvalid)
    assert p_excess(got, want, p_term) <= 0.0
    jwant = jref.chunk_attention_ref(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)),
                                     jnp.asarray(valid))
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), atol=TOL, rtol=0)


@settings(deadline=None, max_examples=8)
@given(g=st.sampled_from([1, 3, 4, 8]), cq=st.integers(1, 40),
       written=st.integers(0, 300), order=st.sampled_from(["in order", "striped", "random"]),
       seed=st.integers(0, 2 ** 16))
def test_chunk_paged_bf16_numerics_within_the_derived_tolerance(g, cq, written, order, seed):
    """Pages of 16 in a 320-key cache in any order, a start anywhere in the
    written pages (0 included), one kv head of group 1, 3, 4 or 8."""
    rng = np.random.default_rng(seed)
    c, p, d = 20, 16, 32
    start = int(rng.integers(0, written + 1))
    perm = {"in order": np.arange(c), "random": rng.permutation(c),
            "striped": (np.arange(c) % (c // 4)) * 4 + np.arange(c) // (c // 4)}[order]
    first = perm * p
    ps = np.where(first < written, first, -1).astype(np.int32)[None, None]
    q, kn = _bf16(rng, 1, cq, g, d, scale=2.0), _bf16(rng, 1, cq, 1, d)
    kp, vp = _bf16(rng, 1, 1, c, p, d), _bf16(rng, 1, 1, c, p, d, scale=4.0)
    vn = _bf16(rng, 1, cq, 1, d, scale=4.0)
    tps, tst = torch.from_numpy(ps), torch.tensor([start], dtype=torch.int32)
    got = chunk_paged_emulated(q, kp, vp, tps, tst, kn, vn)
    f = lambda *ts: [t.float() for t in ts]
    want = tref.chunk_attention_paged_ref(*f(q, kp, vp), tps, tst, *f(kn, vn))
    p_term = tref.chunk_attention_paged_ref(*f(q, kp, vp.abs()), tps, tst, *f(kn, vn.abs()))
    assert p_excess(got, want, p_term) <= 0.0
    jwant = jref.chunk_attention_paged_ref(
        *(jnp.asarray(x.float().numpy()) for x in (q, kp, vp)), jnp.asarray(ps),
        jnp.asarray([start], jnp.int32), *(jnp.asarray(x.float().numpy()) for x in (kn, vn)))
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), atol=TOL, rtol=0)

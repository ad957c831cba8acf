"""PyTorch port, the arithmetic of the Hopper kernels' designs, on the CPU.

The card kernels themselves run only on a card (tests/test_torch_cuda.py).
Here plain-torch emulations of what they compute are held against the port's
plain versions and the JAX reference:

  * paged_attention: the split count (``ops.paged_splits``), and the
    split-KV block's arithmetic: each split's units of 32 keys that hold a
    valid key go in turn to 4 warps, each warp's partial (m, l, o) over its
    keys, merged in warp order, then the splits' in split order
    (``block_emulated``), equals ``paged_attention_ref`` within 1e-5 in f32
    (the two sum in different orders), splits, warps and rows with no valid
    key included, at the main path's three decode shapes in miniature;
  * the same block split over page stripes (the co-placed decode): stripe s
    keeps the keys of the slots it owns, [s·C/S, (s+1)·C/S), and its live
    units go in turn to the warps (``stripe_keys``); merged in stripe order
    it equals the plain composition of ``ops.paged_attention_coplace``
    within 1e-5 and the reference's per-device partials of its masked
    gather, combined, within 2e-5;
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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import paging as jpaging
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref as tref
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

TOL = 2e-5
# the JAX references, jitted: one compile a shape of the whole function,
# where eager dispatch compiles each of its operations a shape
j_paged = jax.jit(jref.paged_attention_ref)
j_flash = jax.jit(jref.flash_attention_ref, static_argnames=("causal", "window", "sink",
                                                             "q_offset"))
j_chunk = jax.jit(jref.chunk_attention_ref)
j_chunk_paged = jax.jit(jref.chunk_attention_paged_ref)
SPLIT_BLOCKS = 132  # one block on each of the H100's SMs
UNIT = 32           # paged_attention's unit of keys
NW = 4              # its consumer warps
BK = 128            # the bf16 flash kernel's key tile


# ---------------------------------------------------------------------------
# paged_attention: split count, and the block's split-warp-merge arithmetic
# ---------------------------------------------------------------------------


def split_units(t: int, n: int):
    """[beg, end) units of 32 keys of each split, as the kernel cuts them."""
    u = -(-t // UNIT)
    return [(s * u // n, (s + 1) * u // n) for s in range(n)]


@settings(deadline=None, max_examples=300)
@given(b=st.integers(1, 96), hkv=st.integers(1, 16), t=st.integers(1, 40000))
def test_paged_splits_fill_the_card_and_keep_128_keys_a_split(b, hkv, t):
    n = ops.paged_splits(b, hkv, t)
    want = SPLIT_BLOCKS // (b * hkv)
    assert n >= 1
    if b * hkv * 2 > SPLIT_BLOCKS:
        assert n == 1                       # a second split would need a second wave
    if n > 1:
        assert b * hkv * n <= SPLIT_BLOCKS  # one wave of one block a SM
        for beg, end in split_units(t, n):  # each split holds >= 128 keys
            assert min(t, end * UNIT) - beg * UNIT >= 128
    assert n == max(1, min(want, t // 128))  # as many as the card and 128 keys allow


def test_paged_splits_at_the_serving_shapes():
    """llama3-8b decode at B=2: retrieval heads (4 kv heads, 4416 tokens),
    streaming heads (4 kv heads, 292 slots), full attention (8, 8256)."""
    assert ops.paged_splits(2, 4, 4416) == 16
    assert ops.paged_splits(2, 4, 292) == 2
    assert ops.paged_splits(2, 8, 8256) == 8
    assert ops.paged_splits(70, 4, 600) == 1


def range_keys(b, hkv, t):
    """(n, B, Hkv, T) bool: the keys of each of the kernel's contiguous
    splits, units [s·U/n, (s+1)·U/n) of 32."""
    keys = torch.zeros(ops.paged_splits(b, hkv, t), b, hkv, t, dtype=torch.bool)
    for s, (beg, end) in enumerate(split_units(t, keys.shape[0])):
        keys[s, ..., beg * UNIT:end * UNIT] = True
    return keys


def block_emulated(q, k, v, valid, keys=None):
    """The split-KV kernel in plain torch, on the attended buffer: each
    split takes the keys ``keys`` gives it ((n, B, Hkv, T) bool; by default
    ``range_keys``); its live units (those with a valid key it takes) go in
    turn to NW warps; each warp's partial (m, l, o) over its keys (the
    identity (NEG_INF, 0, 0) where it has none); the warps' partials merged
    in warp order, the splits' in split order, divided by max(l, 1e-30)
    last. Returns (n, out)."""
    b, hq, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    keys = range_keys(b, hkv, t) if keys is None else keys
    u = -(-t // UNIT)
    splits = []
    for sk in keys:
        vs = valid & sk
        live = torch.nn.functional.pad(vs, (0, u * UNIT - t)).reshape(b, hkv, u, UNIT).any(-1)
        warp = torch.where(live, (live.long().cumsum(dim=-1) - 1) % NW, -1)  # (B, Hkv, U)
        ms, ls, os_ = [], [], []
        for w in range(NW):
            mine = (warp == w).repeat_interleave(UNIT, dim=-1)[..., :t]
            # the warp's partial over the keys it takes in some row: every
            # other key is masked in every row and adds nothing (at least one
            # key, all masked, where it takes none: the identity)
            cols = (sk & mine).flatten(0, 1).any(0).nonzero().flatten()
            cols = cols if cols.numel() else cols.new_zeros(1)
            m, l, o = tref.paged_attention_partial_ref(q, k[:, :, cols], v[:, :, cols],
                                                       (vs & mine)[..., cols])
            ms.append(m), ls.append(l), os_.append(o)
        splits.append(tref.merge_partials_ref(torch.stack(ms), torch.stack(ls),
                                              torch.stack(os_)))
    m, l, o = (torch.stack(x) for x in zip(*splits))
    return len(keys), tref.combine_partials_ref(m, l, o).to(q.dtype)


def _decode_inputs(rng, b, hkv, t, group, d):
    q = rng.standard_normal((b, hkv * group, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, t, d)).astype(np.float32)
    return q, k, v


# (b, hkv, t, group, d): one split; a ragged last unit; two splits; one split
# a stream (B·Hkv > 66); 16 splits; 132 splits of one stream
SPLIT_CASES = [(1, 2, 100, 4, 32), (2, 3, 1000, 3, 64), (40, 4, 300, 2, 32),
               (70, 4, 600, 4, 32), (2, 4, 4416, 4, 64), (1, 1, 33892, 2, 32)]


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_split_and_merge_equals_paged_attention(case):
    b, hkv, t, group, d = case
    rng = np.random.default_rng(t)
    q, k, v = _decode_inputs(rng, b, hkv, t, group, d)
    valid = rng.random((b, hkv, t)) < 0.8
    n = ops.paged_splits(b, hkv, t)
    if n > 1:
        beg, end = split_units(t, n)[1]
        valid[0, 0, beg * UNIT:end * UNIT] = False   # a split with no valid key
    valid[0, -1, :3 * UNIT] = False                  # dead units shift the warps' turns
    valid[-1, -1] = False                            # an all-invalid row
    tq, tk, tv, tvl = (torch.from_numpy(x) for x in (q, k, v, valid))
    n_got, got = block_emulated(tq, tk, tv, tvl)
    assert n_got == n
    want = tref.paged_attention_ref(tq, tk, tv, tvl)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert got[-1, -group:].abs().max().item() == 0.0
    jwant = j_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=TOL, rtol=0)


# the main path's three decode cases in miniature (D = 16): retrieval heads
# on their [sink | 128 selected | local] pages of 32 (138 slots, the sink
# page and the local pages partly valid, the last local page past the
# cache), the streaming ring (292 slots) and the full-attention baseline
# (T = 8256)
@pytest.mark.parametrize("case", ["retrieval", "streaming", "baseline"])
def test_block_emulation_at_the_main_path_shapes(case):
    rng = np.random.default_rng(len(case))
    b, hkv, g, d = 2, 4, 4, 16
    if case == "retrieval":
        c, p = 258, 32
        kp = rng.standard_normal((b, hkv, c, p, d)).astype(np.float32)
        vp = rng.standard_normal((b, hkv, c, p, d)).astype(np.float32)
        sel = np.stack([rng.permutation(np.arange(1, 248))[:128] for _ in range(b * hkv)])
        slots = np.concatenate([np.zeros((b * hkv, 1), np.int64), sel,
                                np.arange(250, 259)[None].repeat(b * hkv, 0)], axis=1)
        slots = slots.reshape(b, hkv, 138).astype(np.int32)
        valid = np.ones((b, hkv, 138, p), bool)
        valid[:, :, 0, 4:] = False                   # the sink page beyond the 4 sinks
        valid[:, :, 129, :20] = False                # the local window's first page
        valid[:, :, -1] = False                      # a local page past the cache
        valid[1, 2, 5:9] = False                     # four sentinel slots
        slots[1, 2, 5:9] = -1
        valid = valid.reshape(b, hkv, 138 * p)
        q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
        tq, tkp, tvp, tsl, tvl = (torch.from_numpy(x) for x in (q, kp, vp, slots, valid))
        tk, tv = tref.gather_pages(tkp, tvp, tsl)
        want = ops.paged_attention_pages(tq, tkp, tvp, tsl, tvl)
    else:
        hkv = hkv if case == "streaming" else 8
        t = 292 if case == "streaming" else 8256
        q, k, v = _decode_inputs(rng, b, hkv, t, g, d)
        valid = rng.random((b, hkv, t)) < 0.9
        tq, tk, tv, tvl = (torch.from_numpy(x) for x in (q, k, v, valid))
        want = ops.paged_attention(tq, tk, tv, tvl)
    n, got = block_emulated(tq, tk, tv, tvl)
    assert n == {"retrieval": 16, "streaming": 2, "baseline": 8}[case]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


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
    jwant = j_flash(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)), **kw)
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
    jwant = j_chunk(*(jnp.asarray(x.float().numpy()) for x in (q, k, v)), jnp.asarray(valid))
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
    jwant = j_chunk_paged(
        *(jnp.asarray(x.float().numpy()) for x in (q, kp, vp)), jnp.asarray(ps),
        jnp.asarray([start], jnp.int32), *(jnp.asarray(x.float().numpy()) for x in (kn, vn)))
    np.testing.assert_allclose(want.numpy(), np.asarray(jwant), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# paged_attention split over page stripes: the co-placed decode
# ---------------------------------------------------------------------------


def stripe_keys(slots, page, capacity, shards):
    """(S, B, Hkv, N*P) bool: the keys of stripe s are the tokens of the
    slots it owns, slot // (C/S) == s for a slot in [0, C); each lane's
    token checks its own slot, so at P < 32 a unit's pieces go to the
    stripes that own their pages."""
    tok = slots.long().repeat_interleave(page, dim=-1)
    own = torch.where((tok >= 0) & (tok < capacity), tok // (capacity // shards), -1)
    return own[None] == torch.arange(shards)[:, None, None, None]


def coplace_emulated(q, kp, vp, slots, valid, shards):
    """The co-placed decode as the kernel computes it: ``block_emulated``
    with one split a stripe, over the pages read in place."""
    k, v = tref.gather_pages(kp, vp, slots)
    return block_emulated(q, k, v, valid, stripe_keys(slots, kp.shape[3], kp.shape[2],
                                                      shards))[1]


def jax_coplace(q, kp, vp, slots, valid, shards, valid_of=None):
    """The reference's co-placed decode on numpy inputs: each device i of
    the 'model' axis holds pages [i·C/S, (i+1)·C/S), masks the attended
    list to its own (loc_masked, src/repro/core/hybrid_attention.py:717-724),
    gathers and takes the partial; combine_partials(impl="ref") merges.
    ``valid_of(i, loc_masked)`` gives device i's validity (default: the
    unsplit validity on its own slots)."""
    b, hkv, c, p, d = kp.shape
    c_loc = c // shards
    parts = []
    for i in range(shards):
        loc = slots - i * c_loc
        mine = (slots >= 0) & (loc >= 0) & (loc < c_loc)
        loc_masked = np.where(mine, loc, -1).astype(np.int32)
        vi = (valid & np.repeat(mine, p, axis=-1) if valid_of is None
              else valid_of(i, loc_masked))
        parts.append(_jax_device_partial(q, kp[:, :, i * c_loc:(i + 1) * c_loc],
                                         vp[:, :, i * c_loc:(i + 1) * c_loc], loc_masked, vi))
    m, l, o = (jnp.stack(x) for x in zip(*parts))
    return np.asarray(_jax_combine(m, l, o))


@jax.jit
def _jax_device_partial(q, kp, vp, loc_masked, valid):
    gk, gv = jpaging.gather_pages(kp, vp, loc_masked)
    return jops.paged_attention_partial(q, gk, gv, valid, impl="ref")


@jax.jit
def _jax_combine(m, l, o):
    return jops.combine_partials(m, l, o, impl="ref")


def _check_coplace(q, kp, vp, slots, valid, shards, valid_of=None):
    tq, tkp, tvp, tsl, tvl = (torch.from_numpy(x) for x in (q, kp, vp, slots, valid))
    got = coplace_emulated(tq, tkp, tvp, tsl, tvl, shards)
    plain = ops.paged_attention_coplace(tq, tkp, tvp, tsl, tvl, shards)
    assert torch.equal(plain, tref.paged_attention_coplace_ref(tq, tkp, tvp, tsl, tvl, shards))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5, rtol=0)
    want = jax_coplace(q, kp, vp, slots, valid, shards, valid_of)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    return got


# (shards, b, hkv, group, c, p, n, d): one stripe; P = 8, so a 32-token unit
# spans pages of several stripes, and N·P/32 not whole; 8 stripes over
# 64 pages; P = 16 at group 1
COPLACE_CASES = [(1, 2, 2, 4, 12, 32, 7, 16), (4, 2, 3, 2, 24, 8, 45, 16),
                 (8, 1, 2, 4, 64, 32, 40, 16), (4, 2, 2, 1, 16, 16, 33, 32)]


@pytest.mark.parametrize("case", COPLACE_CASES)
def test_stripe_split_and_merge_equals_the_coplace_decode(case):
    s, b, hkv, g, c, p, n, d = case
    rng = np.random.default_rng(c * p + n)
    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    kp = rng.standard_normal((b, hkv, c, p, d)).astype(np.float32)
    vp = rng.standard_normal((b, hkv, c, p, d)).astype(np.float32)
    slots = rng.integers(0, c, (b, hkv, n))
    if s > 1:  # the last stripe owns no attended page of row (0, 0)
        c_own = c // s
        slots[0, 0] = np.where(slots[0, 0] >= (s - 1) * c_own, slots[0, 0] % c_own,
                               slots[0, 0])
    slots[0, -1, 1] = -1                         # a sentinel
    slots[-1, 0, 2] = c                          # a slot past the cache
    real = (slots >= 0) & (slots < c)
    valid = (rng.random((b, hkv, n, p)) < 0.7) & real[..., None]
    valid[-1, -1] = False                        # a row with no valid token
    slots, valid = slots.astype(np.int32), valid.reshape(b, hkv, n * p)
    got = _check_coplace(q, kp, vp, slots, valid, s)
    assert got[-1, -g:].abs().max().item() == 0.0
    if s > 1:
        keys = stripe_keys(torch.from_numpy(slots), p, c, s)
        assert not bool((keys[-1, 0, 0] & torch.from_numpy(valid[0, 0])).any())


def test_stripe_split_at_the_main_path_shape():
    """The coplace engine's decode in miniature (D = 16): 4 slots at
    contexts 8200 / 7000 / 5000 / 3000 in 264 pages of 32 over 8 stripes
    (striped page order), a random selection of each slot's selectable
    pages (-1 padded where fewer than 128), the [sink | selected | local]
    list of 138 slots and its validity as the port's decode body builds
    them; the reference builds each device's validity from its own slots
    (paging.token_validity on loc_masked), which must equal the unsplit
    validity on that device's slots."""
    from repro_torch.core import paging as tpaging

    s, b, hkv, g, d, p, c, top_k = 8, 4, 4, 4, 16, 32, 264, 128
    sink, local = 4, 256
    ctx = np.array([8200, 7000, 5000, 3000])
    rng = np.random.default_rng(18)
    lop = tpaging.logical_pages(c, s, "cpu").numpy()
    start = np.where(lop[None] * p < ctx[:, None], lop[None] * p, -1)
    start = np.ascontiguousarray(np.broadcast_to(start[:, None], (b, hkv, c))).astype(np.int32)
    sel = np.full((b, hkv, top_k), -1, np.int64)
    for bi, n_ctx in enumerate(ctx):
        pages = np.arange(1, max(n_ctx - local, 0) // p)
        for hi in range(hkv):
            pick = rng.permutation(pages)[:top_k]
            sel[bi, hi, :len(pick)] = pick
    sel = torch.from_numpy(sel)
    sel = torch.where(sel >= 0, tpaging.interleave_slot(sel, c, s), -1)
    tctx = torch.from_numpy(ctx)
    slots = tpaging.coplace_attended_slots(sel, tctx, sink=sink, local=local, page=p,
                                           capacity=c, n_shards=s)
    valid = tpaging.token_validity(slots, torch.from_numpy(start), tctx, sink=sink,
                                   local=local, page=p, top_k=top_k)
    assert slots.shape == (b, hkv, 138)
    slots, valid = slots.numpy(), valid.numpy()
    c_loc = c // s

    def device_validity(i, loc_masked):
        vi = np.asarray(jpaging.token_validity(
            jnp.asarray(loc_masked), jnp.asarray(start[:, :, i * c_loc:(i + 1) * c_loc]),
            jnp.asarray(ctx), sink=sink, local=local, page=p, top_k=top_k))
        mine = np.repeat(loc_masked >= 0, p, axis=-1)
        np.testing.assert_array_equal(vi, valid & mine)
        return vi

    q = rng.standard_normal((b, hkv * g, d)).astype(np.float32)
    kp = rng.standard_normal((b, hkv, c, p, d)).astype(np.float32)
    vp = rng.standard_normal((b, hkv, c, p, d)).astype(np.float32)
    _check_coplace(q, kp, vp, slots, valid, s, device_validity)


# ---------------------------------------------------------------------------
# page_score's select mode: keys, radix select, compaction, rank placement
# ---------------------------------------------------------------------------

SELECT_CLUSTER = 8   # blocks a row (ops._SELECT_BLOCKS)
SELECT_WARPS = 8     # warps a block
DIGIT = 8            # the radix select's digit width: four passes over 32 bits


def order_key(s):
    """The kernel's order-preserving key of f32 scores, as int64 holding
    the unsigned 32-bit value: -0.0 takes +0.0's key."""
    s = torch.where(s == 0, 0.0, s)
    u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | (1 << 31))


def key_score(key: int) -> float:
    u = key & 0x7FFFFFFF if key >= 1 << 31 else ~key & 0xFFFFFFFF
    return float(torch.tensor([u], dtype=torch.int64).to(torch.int32).view(torch.float32))


def radix_select(keys, k: int):
    """(thr, want): the k-th largest key, and how many keys equal to it the
    top k take, by histogram passes of DIGIT bits from the top; each pass
    picks the digit where the count from the top reaches ``want``, as the
    kernel's warp 0 does from a scan of the block's histogram."""
    prefix, mask, want = 0, 0, k
    bins = 1 << DIGIT
    for shift in range(32 - DIGIT, -1, -DIGIT):
        match = (keys & mask) == prefix
        hist = torch.bincount((keys[match] >> shift) & (bins - 1), minlength=bins)
        incl = hist.flip(0).cumsum(0)         # thread t: digits 255 .. 255 - t
        t = int(torch.nonzero(incl >= want)[0])
        digit = bins - 1 - t
        want -= int(incl[t] - hist[digit])
        prefix |= digit << shift
        mask |= (bins - 1) << shift
    return prefix, want


def select_emulated(scores, top_k: int, minus_one_masked: bool):
    """One row's selection as the leader block computes it from the row's
    keys: radix select of the K-th key, the ordered compaction (keys above
    it, then the first ``want`` equal to it in slot order), each winner
    placed at the count of winners with a larger 64-bit key (score key,
    complemented slot), -1 padding and, with ``minus_one_masked``, -1 for
    masked scores."""
    c = scores.shape[0]
    k = min(top_k, c)
    keys = order_key(scores)
    thr, want = radix_select(keys, k)
    gt = torch.nonzero(keys > thr).flatten().tolist()
    eq = torch.nonzero(keys == thr).flatten().tolist()[:want]
    win = [(int(keys[p]) << 32) | (~p & 0xFFFFFFFF) for p in gt + eq]
    assert len(win) == k
    out = [-1] * top_k
    for w in win:
        rank = sum(x > w for x in win)
        masked = minus_one_masked and key_score(w >> 32) <= -5e29
        out[rank] = -1 if masked else ~w & 0xFFFFFFFF
    return torch.tensor(out, dtype=torch.int32)


def scoring_split(c: int, n: int = SELECT_CLUSTER, nw: int = SELECT_WARPS):
    """The pages each warp of each block of a row's cluster scores."""
    ranges = []
    for r in range(n):
        beg, end = r * c // n, (r + 1) * c // n
        per = -(-(end - beg) // nw)
        for w in range(nw):
            wb = beg + w * per
            ranges.append((wb, min(end, wb + per)))
    return ranges


@pytest.mark.parametrize("c", list(range(1, 70)) + [257, 258, 264, 4096, 16384])
def test_select_scoring_split_scores_every_page_once(c):
    seen = torch.zeros(c, dtype=torch.int64)
    for n in (1, SELECT_CLUSTER):
        seen.zero_()
        for wb, we in scoring_split(c, n):
            if we > wb:
                seen[wb:we] += 1
        assert bool((seen == 1).all())


def _select_rows(kind, rng, c):
    """(4, c) f32 score rows of a kind; NEG_INF marks a masked page."""
    rows = rng.standard_normal((4, c)).astype(np.float32) * 50
    if kind == "ties":
        rows = rng.choice(np.float32([-3.0, -1.0, 0.5, 2.0, 7.0]), (4, c))
    elif kind == "signed zeros":
        rows = rng.choice(np.float32([-0.0, 0.0, -1.0, 1.0]), (4, c))
    elif kind == "neg_inf fill":
        rows[:, : c // 2] = -1e30
    elif kind == "all masked":
        rows[:] = -1e30
    elif kind == "mixed":
        rows = np.where(rng.random((4, c)) < 0.3, np.float32(-1e30),
                        rng.choice(np.float32([-2.0, -0.0, 0.0, 1.0, 3.0]), (4, c)))
    return torch.from_numpy(rows.astype(np.float32))


# (kind, c, top_k): C not a multiple of the cluster's 8 blocks, K above the
# selectable count, K >= C
SELECT_EMU_CASES = [("random", 258, 128), ("ties", 75, 16), ("signed zeros", 37, 20),
                    ("neg_inf fill", 40, 32), ("all masked", 21, 8), ("mixed", 99, 40),
                    ("random", 20, 32), ("mixed", 13, 13), ("ties", 1, 4)]


@pytest.mark.parametrize("case", SELECT_EMU_CASES, ids=str)
def test_select_emulation_equals_the_stable_sort(case):
    """The kernel's selection algorithm equals torch.sort(stable=True)'s
    top-k (``ref.select_top_k``), in both layouts' forms, row by row."""
    kind, c, top_k = case
    rows = _select_rows(kind, np.random.default_rng(c), c)
    for flag in (False, True):
        want = tref.select_top_k(rows, top_k, minus_one_masked=flag)
        got = torch.stack([select_emulated(r, top_k, flag) for r in rows])
        assert torch.equal(got, want), (kind, flag)


def test_order_key_orders_as_the_floats():
    vals = torch.tensor([-np.inf, -1e30, -5e29, -3.5, -1e-38, -0.0, 0.0, 1e-45, 2.0,
                         3e38, np.inf], dtype=torch.float32)
    keys = order_key(vals)
    assert keys[5] == keys[6]                        # -0.0 and +0.0 share a key
    assert bool((keys[1:] >= keys[:-1]).all())
    assert bool((keys[1:5] > keys[:4]).all()) and bool((keys[7:] > keys[6:-1]).all())
    assert all(key_score(int(k)) == float(v) for k, v in zip(keys, vals))

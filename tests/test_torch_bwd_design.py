"""PyTorch port, the arithmetic of flash attention's backward kernels, on the
CPU. The kernels run only on a card (tests/test_torch_cuda.py); here
plain-torch emulations of what they compute, in their tiles' order, are held
against ``ref.flash_attention_bwd_ref`` within the card check's unchanged
tolerances:

  * the f32 route (csrc/flash_attention_bwd.cu): every product 3xTF32 on
    mma.sync, each operand split into hi = x rounded to tf32 as cvt.rna
    rounds and lo = x - hi, of which the MMA reads the top 19 bits (both
    done on the int32 bits), products
    lo·hi + hi·lo + hi·hi into f32 over k8 steps, dq, dk and dv summed in
    chains of 192 MMAs, each then added to the output; launch 1 a 128-row q tile
    over its key tiles (S, dP, then dq += dS·K), launch 2 a 128-key tile
    over the group's heads and its q tiles (Sᵀ, dPᵀ, then dv += Pᵀ·dO and
    dk += dSᵀ·Q); P = 2^(s·scale·log2e - L·log2e) from the forward's L.
    Within 1e-4·max|plain| + 1e-5;
  * the bf16 route (csrc/flash_attention_bwd_sm90.cu): products of bf16
    operands exact in f32, P and dS f32, each split into two bf16 operands
    (hi, then lo of the rest) for the products that read them, outputs
    rounded to bf16. Within 2^-8·|plain| + 1e-4·max|plain| + 1e-5; P and dS
    rounded once to bf16 instead exceed that bound, which is why the kernel
    splits them;
  * ``ref.flash_attention_lse_ref``, the forward's new output, against
    ``jax.nn.logsumexp`` of the JAX reference's scaled, masked scores.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

LOG2E = 1.4426950408889634
MAX_RTOL, ATOL, BF16_RTOL = 1e-4, 1e-5, 2.0 ** -8  # chip_smoke.py's BWD_* bounds


def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the int32 bits, as the kernel rounds hi: the 13
    dropped mantissa bits to nearest, ties away from zero (the magnitude
    rounds up at half)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """What an MMA reads of an f32 register given as tf32: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    """The kernel's split: hi = tf32(x), lo = x - hi as the MMA reads it."""
    hi = tf32(x)
    return hi, tf32_trunc(x - hi)


def mma3(acc, a, b):
    """acc += a·b as the f32 route's 3xTF32 over k8 steps: a (..., M, K),
    b (..., K, N), f32; each step lo·hi + hi·lo + hi·hi in that order."""
    for k0 in range(0, a.shape[-1], 8):
        ah, al = split_tf32(a[..., k0:k0 + 8])
        bh, bl = split_tf32(b[..., k0:k0 + 8, :])
        acc = acc + al @ bh
        acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def split_bf16(x):
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def mma_bf16_split(acc, a, b):
    """acc += a·b with a (f32) as the bf16 route's two operands, lo first."""
    hi, lo = split_bf16(a)
    return acc + lo @ b + hi @ b


def mma_bf16_once(acc, a, b):
    return acc + a.to(torch.bfloat16).float() @ b


def mask_of(rows, cols, causal, window, sink):
    i, j = rows[:, None], cols[None, :]
    ok = torch.ones(len(rows), len(cols), dtype=torch.bool)
    if causal:
        ok &= j <= i
    if window > 0:
        ok &= (j > i - window) | (j < sink)
    return ok


def emulate_bwd(q, k, v, o, do, lse, *, causal, window, sink, q_offset, route,
                split=True):
    """(dq, dk, dv) as the kernels compute them, tile by tile, from f32 (or
    bf16-valued f32) operands. route "f32": 3xTF32, tiles of the f32 kernels
    at D <= 80; route "bf16": bf16 operands, P and dS split (or rounded
    once with split=False), outputs rounded to bf16."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = float(tref._scale(d))
    sl2 = np.float32(scale * LOG2E)
    if route == "f32":
        prod = prod_p = mma3
        # a chain of 192 MMAs (8 tiles of 8 k-steps x 3), then added to the
        # output in device memory and restarted from zero
        bq, bk, bkv, br, flush = 128, 64, 128, 64, 8
    else:
        prod = lambda acc, a, bb: acc + a @ bb  # exact bf16 products, f32 sums
        prod_p = mma_bf16_split if split else mma_bf16_once
        bq, bk, bkv, br, flush = 128, 64, 128, 32, None  # one chain a block
    L2 = torch.where(lse == -torch.inf, torch.inf, lse * LOG2E)  # (B, Hq, Sq)
    delta = (do * o).sum(-1).transpose(1, 2)                      # (B, Hq, Sq)
    dq = torch.zeros_like(q)
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    # launch 1: dq, a q tile over its key tiles
    for h in range(hq):
        kh = h // g
        for r0 in range(0, sq, bq):
            rows = torch.arange(r0, min(r0 + bq, sq))
            qt, gt = q[:, rows, h], do[:, rows, h]
            acc, out, n = torch.zeros_like(qt), torch.zeros_like(qt), 0
            for c0 in range(0, sk, bk):
                cols = torch.arange(c0, min(c0 + bk, sk))
                ok = mask_of(rows + q_offset, cols, causal, window, sink)
                if not ok.any():
                    continue
                kt, vt = k[:, cols, kh], v[:, cols, kh]
                s = prod(torch.zeros(b, len(rows), len(cols)), qt, kt.transpose(1, 2))
                dp = prod(torch.zeros_like(s), gt, vt.transpose(1, 2))
                p = torch.where(ok, torch.exp2(s * sl2 - L2[:, h, rows, None]), 0.0)
                ds = p * (dp - delta[:, h, rows, None])
                acc = prod_p(acc, ds, kt)
                n += 1
                if n == flush:
                    out, acc, n = out + acc * scale, torch.zeros_like(acc), 0
            dq[:, rows, h] = out + acc * scale
    # launch 2: dk and dv, a key tile over the group's heads and q tiles
    for kh in range(hkv):
        for c0 in range(0, sk, bkv):
            cols = torch.arange(c0, min(c0 + bkv, sk))
            kt, vt = k[:, cols, kh], v[:, cols, kh]
            ak, av, ok_, ov = (torch.zeros_like(kt) for _ in range(4))
            n = 0
            for h in range(kh * g, (kh + 1) * g):
                for r0 in range(0, sq, br):
                    rows = torch.arange(r0, min(r0 + br, sq))
                    ok = mask_of(rows + q_offset, cols, causal, window, sink).T
                    if not ok.any():
                        continue
                    qt, gt = q[:, rows, h], do[:, rows, h]
                    st = prod(torch.zeros(b, len(cols), len(rows)), kt, qt.transpose(1, 2))
                    dpt = prod(torch.zeros_like(st), vt, gt.transpose(1, 2))
                    pt = torch.where(ok, torch.exp2(st * sl2 - L2[:, h, None, rows]), 0.0)
                    dst = pt * (dpt - delta[:, h, None, rows])
                    av = prod_p(av, pt, gt)
                    ak = prod_p(ak, dst, qt)
                    n += 1
                    if n == flush:
                        ok_, ov = ok_ + ak * scale, ov + av
                        ak, av, n = torch.zeros_like(ak), torch.zeros_like(av), 0
            dk[:, cols, kh] = ok_ + ak * scale
            dv[:, cols, kh] = ov + av
    if route == "bf16":
        return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))
    return dq, dk, dv


def bwd_excess(got, want, dtype) -> float:
    """chip_smoke.py::bwd_excess: within the check's bound at <= 0."""
    want = want.float()
    lim = MAX_RTOL * want.abs().max() + ATOL
    if dtype == torch.bfloat16:
        lim = lim + BF16_RTOL * want.abs()
    return ((got.float() - want).abs() - lim).max().item()


def inputs(seed, b, s, hq, hkv, d, dtype, mag=1.0):
    rng = np.random.default_rng(seed)
    mk = lambda *sh, m=1.0: torch.from_numpy(
        (m * rng.standard_normal(sh)).astype(np.float32)).to(dtype).float()
    return (mk(b, s, hq, d, m=mag), mk(b, s, hkv, d, m=mag), mk(b, s, hkv, d),
            mk(b, s, hq, d))


# (s, hq, hkv, d, causal, window, sink, q_offset, magnitude of q and k):
# head_dims 32/64/80, GQA 1/3/4, causal, window + sink, a q_offset, and one
# case whose scaled scores reach ~30 (q and k of std 5.5 at D = 64:
# scale·q·k has std ~30), where P is nearly one-hot and dS cancels most
CASES = [
    (150, 2, 2, 32, True, 0, 0, 0, 1.0),
    (140, 6, 2, 64, True, 40, 4, 0, 1.0),
    (90, 4, 1, 80, True, 0, 0, 0, 1.0),
    (70, 8, 2, 32, True, 24, 3, 40, 1.0),
    (130, 3, 1, 64, True, 0, 0, 0, 5.5),
]
IDS = ["d32-g1-causal", "d64-g3-window-sink", "d80-g4-causal",
       "d32-g4-window-sink-offset", "d64-g3-scores30"]


def _check(case, route, split=True):
    s, hq, hkv, d, causal, window, sink, q_offset, mag = case
    dtype = torch.float32 if route == "f32" else torch.bfloat16
    q, k, v, do = inputs(s + hq, 1, s, hq, hkv, d, dtype, mag)
    mask = dict(causal=causal, window=window, sink=sink, q_offset=q_offset)
    o = tref.flash_attention_ref(q, k, v, **mask).to(dtype).float()
    lse = tref.flash_attention_lse_ref(q, k, **mask)
    got = emulate_bwd(q, k, v, o, do, lse, route=route, split=split, **mask)
    want = tref.flash_attention_bwd_ref(q, k, v, o, do, **mask)
    return [bwd_excess(a, w, dtype) for a, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_f32_route_3xtf32_within_the_f32_tolerance(case):
    ex = _check(case, "f32")
    assert max(ex) <= 0.0, ex


def test_tf32_rounding_is_cvt_rna():
    """Round to nearest on the 13 dropped bits, ties away from zero; 11
    significant bits kept, so |x - tf32(x)| <= 2^-11·|x|, and the split
    (lo truncated to 11 bits by the MMA) keeps x within 2^-21·|x|."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 1.0 + 2.0 ** -9])
    assert torch.equal(tf32(x), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split_tf32(r)
    assert ((r - hi).abs() <= 2.0 ** -11 * r.abs()).all()
    assert ((r - hi - lo).abs() <= 2.0 ** -21 * r.abs()).all()
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32_trunc(lo), lo)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_route_split_p_and_ds_within_the_bf16_tolerance(case):
    ex = _check(case, "bf16")
    assert max(ex) <= 0.0, ex


def test_bf16_route_single_rounding_of_p_and_ds_exceeds_the_tolerance():
    """The reason for the split: rounding P and dS once to bf16 moves dv, dq
    and dk by 2^-9 of sums of terms that cancel in them, beyond 2^-8·|plain|
    + 1e-4·max|plain| + 1e-5 (the first case already shows it)."""
    assert max(_check(CASES[0], "bf16", split=False)) > 0.0


@pytest.mark.parametrize("case", [
    dict(hq=4, hkv=2, causal=True, window=0, sink=0, q_offset=0),
    dict(hq=6, hkv=2, causal=True, window=7, sink=3, q_offset=0),
    dict(hq=2, hkv=1, causal=True, window=4, sink=0, q_offset=18),  # rows with no key
    dict(hq=2, hkv=2, causal=False, window=0, sink=0, q_offset=0),
], ids=["causal", "window-sink", "offset-empty-rows", "full"])
def test_lse_ref_matches_jax_logsumexp(case):
    """ref.flash_attention_lse_ref against jax.nn.logsumexp of the JAX
    reference's scaled, masked scores, to 1e-6 relative; a row with no
    allowed key is -inf here, about NEG_INF there."""
    rng = np.random.default_rng(11)
    b, s, d = 2, 21, 16
    hq, hkv = case["hq"], case["hkv"]
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    mask = {key: case[key] for key in ("causal", "window", "sink", "q_offset")}
    got = tref.flash_attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), **mask)
    kx = jref._gqa_expand(jnp.asarray(k), hq)
    logits = jnp.einsum("bihd,bjhd->bhij", jnp.asarray(q), kx,
                        preferred_element_type=jnp.float32) / jnp.sqrt(jnp.float32(d))
    i = jnp.arange(s)[:, None] + mask["q_offset"]
    j = jnp.arange(s)[None, :]
    ok = jnp.ones((s, s), dtype=bool)
    if mask["causal"]:
        ok &= j <= i
    if mask["window"] > 0:
        win = j > (i - mask["window"])
        if mask["sink"] > 0:
            win |= j < mask["sink"]
        ok &= win
    want = np.asarray(jax.nn.logsumexp(jnp.where(ok[None, None], logits, jref.NEG_INF),
                                       axis=-1))
    empty = want <= jref.NEG_INF / 2
    assert np.array_equal(np.isneginf(got.numpy()), empty)
    assert empty.any() == (case["q_offset"] > 0)
    np.testing.assert_allclose(got.numpy()[~empty], want[~empty], rtol=1e-6, atol=1e-6)

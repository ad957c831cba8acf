"""Per-request sampling, temperature and top-p (counterpart of
``repro/serving/sampling.py``).

Every sampled token's random key is a function of ``(seed, Request.uid,
generation index)`` alone:

    base_g = fold_in(PRNGKey(seed), uid)     # once a request
    key_i  = fold_in(base_g, i)              # the i-th token emitted

never of the slot a request sits in or the step that runs it. So a trace
does not depend on slot churn or admission order, and the verify step's
sampler (``sample_chunk``) draws the very keys of the step sampler: a
speculative run emits the tokens of a non-speculative one, sample for
sample.

The keys are JAX's raw threefry keys, and this module computes them as
``jax.random`` does (jax 0.9.0, ``jax_threefry_partitionable`` on): the
Threefry-2x32 hash, ``fold_in``, the partitionable ``random_bits`` (the
counter of element i is the pair (hi, lo) of i, the bits ``bits1 ^
bits2``), the f32 ``uniform`` and the "low" ``gumbel``. The bits are equal
bit for bit; the Gumbel values differ from JAX's only by the last bits of
``log``. A key is a pair of 32-bit words held in an int64 tensor (torch
has few uint32 kernels on the card), every sum and shift masked to 32
bits.

Greedy decoding is the ``temperature == 0`` lane of the one sampler
(``argmax``, the first maximal index). No operation here reads from the
card: the sampler runs inside the engine's captured steps.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

GREEDY_TEMP = 0.0   # the temperature that means argmax
_MIN_TEMP = 1e-6    # divisor guard of the (unused) stochastic lane at t = 0
_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_TINY = 1.1754943508222875e-38  # np.finfo(np.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """A request's sampling policy; the defaults are greedy argmax."""

    temperature: float = GREEDY_TEMP
    top_p: float = 1.0
    seed: int = 0

    def validate(self):
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        return self


# ---------------------------------------------------------------------------
# Threefry-2x32 and the raw-key functions of jax.random
# ---------------------------------------------------------------------------


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of the counters (x1, x2) under the key (k1,
    k2): 20 rounds, a key injection every 4 (``jax._src.prng``'s lowering).
    Every argument an int64 tensor (or int) of 32-bit values; they
    broadcast. Returns the pair of hashed words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def threefry_seed(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor: a 32-bit seed
    gives the words (0, seed)."""
    seed = int(seed)
    hi = 0 if -(1 << 31) <= seed < (1 << 31) else (seed >> 32) & _MASK
    return torch.tensor([hi, seed & _MASK], dtype=torch.int64)


PRNGKey = threefry_seed


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: key (..., 2) int64, data an int or an integer
    tensor broadcasting against key[..., 0] -> (..., 2) int64, the hash of
    the counter pair (0, data) under the key."""
    if not isinstance(data, torch.Tensor):  # no host-to-card copy
        data = torch.full_like(key[..., 0], int(data) & _MASK)
    data = data.to(torch.int64) & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], dim=-1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``random_bits`` on the partitionable path: key (..., 2) int64
    -> (..., *shape) int64. Element i of ``shape`` (flat) hashes the
    counter pair (i >> 32, i & 0xFFFFFFFF); the bits are the two words'
    xor. A batch of keys gives a batch of independent draws."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = key[..., 0].reshape(view)
    k2 = key[..., 1].reshape(view)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return b1 ^ b2


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` on the partitionable path: (num, 2) keys, key i
    the hash of the counter pair (0, i), which is ``fold_in(key, i)``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    return fold_in(key[None, :].expand(num, 2), idx)


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 ``jax.random.randint`` in [minval, maxval): 32 high and 32 low
    bits from the key's two halves of ``split``, reduced modulo the span
    in uint32 arithmetic (2^32 mod span as (2^16 mod span)^2 mod span,
    products wrapped to 32 bits), as jax does."""
    k1, k2 = split(key, 2)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = max(int(maxval) - int(minval), 1) & _MASK
    mult = ((((1 << 16) % span) ** 2) & _MASK) % span
    off = (((hi % span) * mult) & _MASK) + lo % span
    return ((off & _MASK) % span + int(minval)).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float, shape) -> torch.Tensor:
    """``jax.random.bernoulli`` in its "low" mode: an f32 uniform below p."""
    return uniform(key, shape) < float(np.float32(p))


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 ``jax.random.uniform``: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled into [minval, maxval) and max-ed with
    minval."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    scale = float(np.float32(maxval) - np.float32(minval))  # in f32, as JAX
    return torch.clamp(f * scale + lo, min=lo)


def gumbel(key: torch.Tensor, shape) -> torch.Tensor:
    """f32 ``jax.random.gumbel`` in its "low" mode: -log(-log(u)) of a
    uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, minval=_F32_TINY)))


# ---------------------------------------------------------------------------
# Keys of requests and tokens; the samplers
# ---------------------------------------------------------------------------


def request_key(seed: int, uid: int) -> torch.Tensor:
    """A request's base key, fold_in(PRNGKey(seed), uid): (2,) int64 on the
    CPU (the engine copies it into its steps' inputs)."""
    return fold_in(PRNGKey(seed), int(uid))


def token_key(base: torch.Tensor, gen_idx) -> torch.Tensor:
    """The key of the ``gen_idx``-th token emitted (0: the prefill's)."""
    return fold_in(base, gen_idx)


def _sample_rows(logits, keys, temperature, top_p):
    """One token id from each (V,) row of ``logits`` (R, V) with the row's
    key (R, 2), temperature and top-p (R,) -> (R,) int32.

    temperature 0 -> argmax. Otherwise the temperature-scaled log-softmax
    in f32, the nucleus (the shortest prefix of the vocabulary sorted by
    descending probability whose mass reaches top_p; the top token always
    stays; a stable sort orders ties as ``jnp.argsort`` does), and a
    Gumbel-max draw with the row's key."""
    v = logits.shape[-1]
    greedy = logits.argmax(dim=-1)
    t = torch.clamp(temperature.float(), min=_MIN_TEMP)[:, None]
    logp = torch.log_softmax(logits.float() / t, dim=-1)
    probs = torch.exp(logp)
    neg_sorted, order = torch.sort(-probs, dim=-1, stable=True)
    sorted_p = -neg_sorted
    cum_before = torch.cumsum(sorted_p, dim=-1) - sorted_p
    keep_sorted = cum_before < top_p.float()[:, None]
    keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
    filtered = torch.where(keep, logp, float("-inf"))
    stoch = (filtered + gumbel(keys, (v,))).argmax(dim=-1)
    return torch.where(temperature <= GREEDY_TEMP, greedy, stoch).to(torch.int32)


def sample_tokens(logits, base, gen_idx, temperature, top_p):
    """The batched sampler: logits (B, V), base keys (B, 2) int64,
    gen_idx (B,) int, temperature/top_p (B,) -> token ids (B,) int32. Row b
    draws with the key fold_in(base_b, gen_b)."""
    return _sample_rows(logits, token_key(base, gen_idx), temperature, top_p)


def sample_chunk(logits, base, gen_idx, temperature, top_p):
    """The verify chunk's sampler: logits (B, k, V) -> tokens (B, k) int32.
    Row j of slot b is the target of generation index gen_b + j and draws
    with fold_in(base_b, gen_b + j), the key the step sampler would use for
    that token: what makes the verify step lossless sample for sample."""
    b, k, v = logits.shape
    gens = gen_idx.reshape(b, 1).to(torch.int64) + torch.arange(
        k, dtype=torch.int64, device=logits.device)
    keys = token_key(base[:, None, :].expand(b, k, 2), gens)
    rep = lambda x: x.reshape(b, 1).expand(b, k).reshape(-1)
    return _sample_rows(logits.reshape(b * k, v), keys.reshape(b * k, 2),
                        rep(temperature), rep(top_p)).reshape(b, k)

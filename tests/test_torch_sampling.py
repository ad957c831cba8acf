"""PyTorch port, per-request sampling (``repro_torch/serving/sampling.py``)
against ``jax.random`` and ``repro.serving.sampling`` on the CPU.

  * Threefry-2x32, ``PRNGKey``, ``fold_in``, the request and token keys and
    the partitionable ``random_bits`` (jax 0.9.0 takes that path:
    ``jax_threefry_partitionable`` is on) are equal bit for bit.
  * ``uniform`` is equal bit for bit; ``gumbel`` within 2 ulp of
    max(|g|, 1): both sides take two f32 logs of equal uniforms, and each
    log may round its last bit differently (near g = 0 the outer log's
    argument is near 1, so the error is absolute there).
  * ``sample_tokens`` and ``sample_chunk`` draw the tokens JAX draws from
    the same f32 logits. Where a token differs, the JAX row must hold a
    near-tie: the top two of ``filtered + gumbel`` within 1e-5 of each
    other, or a probability mass before the top-p boundary within 1e-6 of
    top_p (the two sides' softmax and cumulative sums round differently).
  * The temperature-0 lane is ``argmax`` (the first maximal index) bit for
    bit, a tiny top-p gives ``argmax``, and ``SamplingParams.validate``
    raises as JAX's does.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.serving import sampling as jsamp  # noqa: E402
from repro_torch.serving import sampling as tsamp  # noqa: E402
import _torch_threads  # noqa: F401,E402  (one torch thread a process)

GUMBEL_ULP = 2
TIE_GAP = 1e-5
TOP_P_BAND = 1e-6
SEEDS = [0, 1, 3, 2 ** 31 - 1]


def _j(key):
    """A JAX raw key as int64 numpy."""
    return np.asarray(key).astype(np.int64)


def test_threefry_is_on_the_partitionable_path():
    assert jax.config.jax_threefry_partitionable


def test_threefry2x32_matches_jax():
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 2 ** 32, size=(6, 2), dtype=np.uint64).astype(np.uint32)
    counts = rng.integers(0, 2 ** 32, size=(2, 37), dtype=np.uint64).astype(np.uint32)
    for k in keys:
        y1, y2 = jprng.threefry2x32_p.bind(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                           jnp.asarray(counts[0]), jnp.asarray(counts[1]))
        t1, t2 = tsamp.threefry2x32(int(k[0]), int(k[1]),
                                    torch.from_numpy(counts[0].astype(np.int64)),
                                    torch.from_numpy(counts[1].astype(np.int64)))
        np.testing.assert_array_equal(t1.numpy(), _j(y1))
        np.testing.assert_array_equal(t2.numpy(), _j(y2))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    """PRNGKey, fold_in, request_key and token_key, bit for bit (uid 0 and
    generation index 0 included)."""
    np.testing.assert_array_equal(tsamp.PRNGKey(seed).numpy(),
                                  _j(jax.random.PRNGKey(seed)))
    for uid in (0, 1, 7, 65535):
        jb, tb = jsamp.request_key(seed, uid), tsamp.request_key(seed, uid)
        np.testing.assert_array_equal(tb.numpy(), _j(jb))
        for gen in (0, 1, 11, 300):
            np.testing.assert_array_equal(tsamp.token_key(tb, gen).numpy(),
                                          _j(jsamp.token_key(jb, gen)))
    # a batch of keys folded with a batch of indices, as the samplers do
    base = torch.stack([tsamp.request_key(seed, u) for u in range(4)])
    gens = torch.tensor([0, 5, 2 ** 20, 3], dtype=torch.int32)
    got = tsamp.fold_in(base, gens).numpy()
    for u in range(4):
        np.testing.assert_array_equal(
            got[u], _j(jax.random.fold_in(jsamp.request_key(seed, u), int(gens[u]))))


@pytest.mark.parametrize("shape", [(37,), (3, 53), (4096,)])
def test_random_bits_match_jax(shape):
    """The partitionable 32-bit random_bits, one key and a batch of keys
    (each row its own draw), bit for bit."""
    for seed in (0, 9):
        jk = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            tsamp.random_bits(tsamp.PRNGKey(seed), shape).numpy(),
            _j(jax.random.bits(jk, shape, jnp.uint32)))
    base = torch.stack([tsamp.request_key(2, u) for u in range(3)])
    got = tsamp.random_bits(base, shape).numpy()
    for u in range(3):
        np.testing.assert_array_equal(
            got[u], _j(jax.random.bits(jsamp.request_key(2, u), shape, jnp.uint32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_and_gumbel_match_jax(seed):
    shape = (8, 1000)
    jk, tk = jax.random.PRNGKey(seed), tsamp.PRNGKey(seed)
    np.testing.assert_array_equal(tsamp.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(jk, shape)))
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_array_equal(
        tsamp.uniform(tk, shape, minval=tiny).numpy(),
        np.asarray(jax.random.uniform(jk, shape, minval=tiny)))
    jg = np.asarray(jax.random.gumbel(jk, shape))
    tg = tsamp.gumbel(tk, shape).numpy()
    ulp = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
    assert np.all(np.abs(tg - jg) <= GUMBEL_ULP * ulp)


def _lanes(b, seed, temperature, top_p):
    jbase = jnp.stack([jsamp.request_key(seed, u) for u in range(b)])
    tbase = torch.stack([tsamp.request_key(seed, u) for u in range(b)])
    t = np.asarray(temperature, np.float32).reshape(-1).repeat(b)[:b] \
        if np.ndim(temperature) == 0 else np.asarray(temperature, np.float32)
    p = np.asarray(top_p, np.float32).reshape(-1).repeat(b)[:b] \
        if np.ndim(top_p) == 0 else np.asarray(top_p, np.float32)
    return jbase, tbase, t, p


def _near_tie(logits, key, temperature, top_p) -> bool:
    """Whether JAX's draw from one (V,) row sits on a near-tie: the top two
    of ``filtered + gumbel`` within TIE_GAP, or a mass before the top-p
    boundary within TOP_P_BAND of top_p."""
    t = max(float(temperature), 1e-6)
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits, jnp.float32) / t))
    probs = np.exp(logp)
    order = np.argsort(-probs, kind="stable")
    sp = probs[order]
    cum_before = np.cumsum(sp.astype(np.float64)) - sp
    if np.min(np.abs(cum_before - top_p)) < TOP_P_BAND:
        return True
    keep = np.zeros(len(logits), bool)
    keep[order] = cum_before < top_p
    g = np.asarray(jax.random.gumbel(key, (len(logits),)))
    z = np.sort(np.where(keep, logp + g, -np.inf))[-2:]
    return bool(z[1] - z[0] < TIE_GAP)


def _check_rows(got, want, logits, keys, temps, topps):
    for r in np.nonzero(got != want)[0]:
        assert _near_tie(logits[r], keys[r], temps[r], topps[r]), (
            f"row {r}: {got[r]} vs {want[r]} without a near-tie")


@given(seed=st.integers(min_value=0, max_value=1 << 20),
       temperature=st.floats(min_value=0.0, max_value=2.0),
       top_p=st.floats(min_value=0.05, max_value=1.0))
@settings(max_examples=10, deadline=None)
def test_sample_tokens_matches_jax(seed, temperature, top_p):
    b, v = 4, 1000
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    jbase, tbase, t, p = _lanes(b, seed % 97, temperature, top_p)
    t[0] = 0.0  # one greedy lane in every batch
    gen = np.asarray([0, 3, 11, 300], np.int32)
    want = np.asarray(jsamp.sample_tokens(jnp.asarray(logits), jbase, gen, t, p))
    got = tsamp.sample_tokens(torch.from_numpy(logits), tbase, torch.from_numpy(gen),
                              torch.from_numpy(t), torch.from_numpy(p)).numpy()
    keys = [jsamp.token_key(jbase[i], int(gen[i])) for i in range(b)]
    _check_rows(got, want, logits, keys, t, p)


@given(seed=st.integers(min_value=0, max_value=1 << 20),
       temperature=st.floats(min_value=0.1, max_value=2.0),
       top_p=st.floats(min_value=0.05, max_value=1.0))
@settings(max_examples=6, deadline=None)
def test_sample_chunk_matches_jax_and_the_step_sampler(seed, temperature, top_p):
    """``sample_chunk`` against JAX's, and column j against the port's step
    sampler at generation index gen + j (the coupling speculation rests
    on, exact within the port)."""
    b, k, v = 3, 5, 257
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, k, v)).astype(np.float32)
    jbase, tbase, t, p = _lanes(b, seed % 89, temperature, top_p)
    gen = np.asarray([0, 3, 11], np.int32)
    want = np.asarray(jsamp.sample_chunk(jnp.asarray(logits), jbase, gen, t, p))
    tl, tg, tt, tp = (torch.from_numpy(x) for x in (logits, gen, t, p))
    got = tsamp.sample_chunk(tl, tbase, tg, tt, tp).numpy()
    for j in range(k):
        keys = [jsamp.token_key(jbase[i], int(gen[i]) + j) for i in range(b)]
        _check_rows(got[:, j], want[:, j], logits[:, j], keys, t, p)
        step = tsamp.sample_tokens(tl[:, j], tbase, tg + j, tt, tp).numpy()
        np.testing.assert_array_equal(got[:, j], step)


def test_greedy_lane_is_argmax_bit_for_bit():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((5, 37)).astype(np.float32)
    logits[1, [3, 20]] = logits[1].max() + 1.0  # a tie: the first index wins
    _, tbase, _, _ = _lanes(5, 0, 0.0, 1.0)
    got = tsamp.sample_tokens(torch.from_numpy(logits), tbase,
                              torch.zeros(5, dtype=torch.int32), torch.zeros(5),
                              torch.ones(5)).numpy()
    np.testing.assert_array_equal(got, np.argmax(logits, -1))
    jbase = jnp.stack([jsamp.request_key(0, u) for u in range(5)])
    np.testing.assert_array_equal(
        got, np.asarray(jsamp.sample_tokens(jnp.asarray(logits), jbase,
                                            np.zeros(5, np.int32),
                                            np.zeros(5, np.float32),
                                            np.ones(5, np.float32))))
    assert got[1] == 3


def test_tiny_top_p_is_argmax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((6, 53)).astype(np.float32)
    _, tbase, _, _ = _lanes(6, 9, 0.0, 1.0)
    got = tsamp.sample_tokens(torch.from_numpy(logits), tbase,
                              torch.arange(6, dtype=torch.int32),
                              torch.full((6,), 1.3), torch.full((6,), 1e-6)).numpy()
    np.testing.assert_array_equal(got, np.argmax(logits, -1))


def test_stochastic_lane_samples():
    """At temperature 1 the draws are not the argmax everywhere, and a
    different seed draws differently: the stochastic lane is live."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    draw = lambda seed: tsamp.sample_tokens(
        logits, torch.stack([tsamp.request_key(seed, u) for u in range(16)]),
        torch.zeros(16, dtype=torch.int32), torch.ones(16), torch.ones(16))
    a, b = draw(1), draw(2)
    assert not torch.equal(a, logits.argmax(-1).to(torch.int32))
    assert not torch.equal(a, b)
    assert torch.equal(a, draw(1))


@pytest.mark.parametrize("kw,what", [
    (dict(), None), (dict(temperature=0.7, top_p=0.9, seed=3), None),
    (dict(temperature=-0.1), "temperature"), (dict(top_p=0.0), "top_p"),
    (dict(top_p=1.5), "top_p"),
])
def test_sampling_params_validate_as_jax(kw, what):
    for mod in (jsamp, tsamp):
        if what is None:
            mod.SamplingParams(**kw).validate()
        else:
            with pytest.raises(ValueError, match=what):
                mod.SamplingParams(**kw).validate()

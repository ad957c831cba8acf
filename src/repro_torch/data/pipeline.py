"""Deterministic, seekable synthetic data (counterpart of
``repro/data/pipeline.py``).

Every batch is a function of (seed, step) alone, drawn with the port's
threefry (``serving/sampling.py``: jax 0.9.0's ``fold_in``, ``split``,
``uniform``, ``randint`` and ``bernoulli``, bit for bit), so a run
restarted from a checkpoint at step N regenerates exactly the batches it
would have seen, and the batches are JAX's. Batches are made on the CPU
(a caller moves them), so a run on the card sees the CPU's tokens. One known exception:
``lm_batch``'s zipf transform takes ``exp`` and ``log`` of f32 values,
whose last bits torch and XLA may round differently; a token differs
where the transformed value lies within an ulp of an integer.

  lm_batch    zipf-distributed tokens with first-order structure;
  niah_batch  needle in a haystack: a (key, value) pair planted at a depth
              inside filler, the key repeated at the end.
"""
from __future__ import annotations

import torch

from repro_torch.serving import sampling as rng


def _keys(seed: int, step: int, n: int):
    return rng.split(rng.fold_in(rng.PRNGKey(seed), int(step)), n)


def lm_batch(step: int, *, batch: int, seq: int, vocab: int, seed: int = 0):
    """{tokens (B, S) int32, labels (B, S) int32}: a zipf-ish unigram draw
    mixed half and half with a first-order recurrence (token_t a function
    of token_{t-1}); labels are the tokens shifted left, -100 last."""
    k1, k2, _ = _keys(seed, step, 3)
    u = rng.uniform(k1, (batch, seq), minval=1e-6, maxval=1.0)
    base = torch.exp(-torch.log(u) * 0.35) - 1.0
    base = base.to(torch.int32).clamp(0, vocab - 1)
    mix = rng.bernoulli(k2, 0.5, (batch, seq))
    det = (torch.roll(base, 1, dims=1) * 31 + 7) % vocab
    tokens = torch.where(mix, det, base).to(torch.int32)
    labels = torch.roll(tokens, -1, dims=1)
    labels[:, -1] = -100
    return {"tokens": tokens, "labels": labels}


def niah_batch(step: int, *, batch: int, seq: int, vocab: int,
               depth_frac: float = 0.5, seed: int = 0):
    """Needle-in-a-haystack probes: per row [filler .. K V .. filler .. K],
    whose next token is V. K is drawn from [vocab-64, vocab-32), V from
    [vocab-32, vocab). Returns tokens, the answer V (B,) and the needle
    position (an int)."""
    k1, k2, k3 = _keys(seed, step, 3)
    filler = rng.randint(k1, (batch, seq), 0, max(vocab - 64, 1))
    kk = rng.randint(k2, (batch,), vocab - 64, vocab - 32)
    vv = rng.randint(k3, (batch,), vocab - 32, vocab)
    pos = min(max(int(seq * depth_frac), 0), seq - 3)
    tokens = filler.clone()
    tokens[:, pos] = kk
    tokens[:, pos + 1] = vv
    tokens[:, -1] = kk
    return {"tokens": tokens, "answer": vv, "needle_pos": pos}


def token_stream(*, batch: int, seq: int, vocab: int, seed: int = 0):
    """Endless ``lm_batch`` steps 0, 1, 2, ..."""
    step = 0
    while True:
        yield lm_batch(step, batch=batch, seq=seq, vocab=vocab, seed=seed)
        step += 1

"""Plain PyTorch versions of the ported kernels.

Counterparts of ``repro/kernels/ref.py``, with its casts kept exactly: q is
cast to the key dtype, logits are f32 (storage-dtype operands, f32
accumulation: the product of two bf16 values is exact in f32, so the
operands are widened before the matmul), probabilities are cast to the
value dtype before the PV product, and the outputs are cast to q's dtype.

  q  (prefill): (B, S, Hq, D)      q (decode): (B, Hq, D)
  k/v (prefill): (B, S, Hkv, D)    gathered kv (decode): (B, Hkv, T, D)
  q  (chunk):   (B, Cq, Hq, D)     chunk kv (paged chunk): (B, Cq, Hr, D)
  stacked partials (combine): m/l (N, B, Hq), o (N, B, Hq, D), f32

The CPU path of ``repro_torch/kernels/ops.py`` runs these; on the card they are what
each CUDA kernel is held against.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _scale(d: int) -> torch.Tensor:
    """1/sqrt(d) computed in f32, as the reference computes it."""
    return torch.tensor(float(d), dtype=torch.float32).sqrt().reciprocal()


def _mm_f32(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with storage-dtype operands and f32 accumulation."""
    return torch.einsum(spec, a.float(), b.float())


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        sink: int = 0, q_offset: int = 0):
    """Prefill attention. q: (B, Sq, Hq, D), k/v: (B, Sk, Hkv, D).

    window>0 keeps keys j in (i-window, i]; sink>0 additionally keeps
    j < sink (only together with a window). q_offset is the absolute
    position of q[0]. A row with every key masked softmaxes over uniform
    NEG_INF logits (the mean of v), as the reference does; the CUDA kernel
    returns 0 there, like the TPU kernel. The serving path never builds
    such a row: every causal query attends at least itself.
    Returns (B, Sq, Hq, D) in q's dtype.
    """
    b, sq, hq, d = q.shape
    sk = k.shape[1]
    group = hq // k.shape[2]
    kx = k.repeat_interleave(group, dim=2) if group > 1 else k
    vx = v.repeat_interleave(group, dim=2) if group > 1 else v
    logits = _mm_f32("bihd,bjhd->bhij", q.to(k.dtype), kx) * _scale(d).to(q.device)
    i = torch.arange(sq, device=q.device)[:, None] + q_offset
    j = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        win = j > (i - window)
        if sink > 0:
            win |= j < sink
        mask &= win
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = _mm_f32("bhij,bjhd->bihd", p.to(v.dtype), vx)
    return out.to(q.dtype)


def paged_attention_ref(q, k, v, valid):
    """Decode attention. q: (B, Hq, D); k/v: (B, Hkv, T, D); valid:
    (B, Hkv, T) bool. softmax(q·kᵀ)·v over valid positions; a row with no
    valid position gives 0. Returns (B, Hq, D) in q's dtype."""
    b, hq, d = q.shape
    h_kv = k.shape[1]
    group = hq // h_kv
    qg = q.reshape(b, h_kv, group, d).to(k.dtype)
    logits = _mm_f32("bhgd,bhtd->bhgt", qg, k) * _scale(d).to(q.device)
    logits = torch.where(valid[:, :, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    any_valid = valid.any(dim=-1)[:, :, None, None]
    p = torch.where(any_valid, p, 0.0)
    out = _mm_f32("bhgt,bhtd->bhgd", p.to(v.dtype), v)
    return out.reshape(b, hq, d).to(q.dtype)


def page_score_ref(q, tau_min, tau_max):
    """Quest page score. q: (B, Hq, D); tau_min/max: (B, Hkv, C, D) ->
    (B, Hkv, C) f32 = Σ_g relu(q_g)·τmax + min(q_g, 0)·τmin, the upper
    bound on any key's logit in the page. Masks nothing: an empty page
    (τ = ±inf) scores NaN, and ``core/paging.score_pages`` masks it."""
    b, hq, d = q.shape
    h_kv = tau_min.shape[1]
    group = hq // h_kv
    qg = q.reshape(b, h_kv, group, d).to(tau_min.dtype)
    qp = torch.clamp(qg, min=0)
    qn = torch.clamp(qg, max=0)
    hi = _mm_f32("bhgd,bhpd->bhgp", qp, tau_max)
    lo = _mm_f32("bhgd,bhpd->bhgp", qn, tau_min)
    return (hi + lo).sum(dim=2)


def chunk_attention_ref(q, k, v, valid):
    """Multi-query attention over a gathered KV buffer (chunked prefill).

    q: (B, Cq, Hq, D); k/v: (B, Hkv, T, D); valid: (B, Hkv, Cq, T) bool,
    a mask per query (the caller derives it from absolute positions).
    ``paged_attention_ref`` is the Cq == 1 case. A row with no valid key
    gives 0. Returns (B, Cq, Hq, D) in q's dtype.
    """
    b, cq, hq, d = q.shape
    h_kv = k.shape[1]
    group = hq // h_kv
    qg = q.reshape(b, cq, h_kv, group, d).to(k.dtype)
    logits = _mm_f32("bchgd,bhtd->bhgct", qg, k) * _scale(d).to(q.device)
    logits = torch.where(valid[:, :, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    any_valid = valid.any(dim=-1)[:, :, None, :, None]
    p = torch.where(any_valid, p, 0.0)
    out = _mm_f32("bhgct,bhtd->bchgd", p.to(v.dtype), v)
    return out.reshape(b, cq, hq, d).to(q.dtype)


def chunk_attention_paged_ref(q, k_pages, v_pages, page_start, start, k_new,
                              v_new):
    """Chunked-prefill retrieval attention over the pre-append paged cache.

    q: (B, Cq, Hq, D); k/v_pages: (B, Hr, C, P, D), the cache BEFORE the
    chunk is appended; page_start: (B, Hr, C) int, the absolute position of
    each page's first token (-1 unwritten); start: (B,) tokens already in
    each slot; k/v_new: (B, Cq, Hr, D), the chunk's own keys and values.
    A cached key counts iff its page is written and its position is below
    ``start`` (every cached key precedes every chunk query); chunk key j
    counts for query c iff j <= c. Every query attends at least itself.
    Returns (B, Cq, Hq, D) in q's dtype.
    """
    b, cq, hq, d = q.shape
    hr, c, p = k_pages.shape[1:4]
    group = hq // hr
    scale = _scale(d).to(q.device)
    kb = k_pages.reshape(b, hr, c * p, d)
    vb = v_pages.reshape(b, hr, c * p, d)
    offs = torch.arange(p, dtype=torch.int32, device=q.device)
    pos = (page_start[..., None] + offs).reshape(b, hr, c * p)
    written = (page_start >= 0)[..., None].expand(b, hr, c, p).reshape(b, hr, c * p)
    cache_ok = written & (pos < start.reshape(b, 1, 1))
    qg = q.reshape(b, cq, hr, group, d).to(kb.dtype)
    lc = _mm_f32("bchgd,bhtd->bhgct", qg, kb) * scale
    lc = torch.where(cache_ok[:, :, None, None, :], lc, NEG_INF)
    kn = k_new.to(kb.dtype)
    ln = _mm_f32("bchgd,bjhd->bhgcj", qg, kn) * scale
    ar = torch.arange(cq, device=q.device)
    ln = torch.where(ar[:, None] >= ar[None, :], ln, NEG_INF)
    probs = torch.softmax(torch.cat([lc, ln], dim=-1), dim=-1)
    out = _mm_f32("bhgct,bhtd->bchgd", probs[..., : c * p].to(vb.dtype), vb)
    out = out + _mm_f32("bhgcj,bjhd->bchgd", probs[..., c * p:].to(v_new.dtype),
                        v_new.to(vb.dtype))
    return out.reshape(b, cq, hq, d).to(q.dtype)


def paged_attention_partial_ref(q, k, v, valid):
    """Partial (unnormalised) decode attention, the contract of the
    cross-stripe combine. q: (B, Hq, D); k/v: (B, Hkv, T, D); valid:
    (B, Hkv, T) bool. Returns, in f32:

      m (B, Hq): the largest valid logit; NEG_INF (a FINITE sentinel, never
        -inf) when the row has no valid token;
      l (B, Hq): the sum of exp(logit - m) over valid tokens, 0 for such a row;
      o (B, Hq, D): the numerator sum(exp(logit - m) * v), 0 for such a row.

    The unnormalised p is cast to v's dtype before the PV product, as the
    reference does. (NEG_INF, 0, 0) is the identity of ``merge_partials_ref``.
    """
    b, hq, d = q.shape
    h_kv = k.shape[1]
    group = hq // h_kv
    qg = q.reshape(b, h_kv, group, d).to(k.dtype)
    logits = _mm_f32("bhgd,bhtd->bhgt", qg, k) * _scale(d).to(q.device)
    logits = torch.where(valid[:, :, None, :], logits, float("-inf"))
    m = logits.amax(dim=-1)
    finite = torch.isfinite(m)
    p = torch.exp(logits - torch.where(finite, m, 0.0)[..., None])
    p = torch.where(valid[:, :, None, :], p, 0.0)
    l = p.sum(dim=-1)
    o = _mm_f32("bhgt,bhtd->bhgd", p.to(v.dtype), v)
    m = torch.where(finite, m, NEG_INF)
    return m.reshape(b, hq), l.reshape(b, hq), o.reshape(b, hq, d)


def paged_attention_partial_pages_ref(q, k_pages, v_pages, slots, valid):
    """``paged_attention_partial_ref`` of every page stripe at once, on the
    pages each stripe attends: the plain version of the fused-gather kernel.

    q: (B, Hq, D); k/v_pages: (B, Hkv, C, P, D); slots: (S, B, Hkv, N) int
    page slots of each stripe, -1 where the stripe attends none (it reads
    page 0 there, which ``valid`` masks); valid: (S, B, Hkv, N*P) bool.
    Returns m, l (S, B, Hq) and o (S, B, Hq, D), f32.
    """
    s, b, h, n = slots.shape
    c, p, d = k_pages.shape[2:]
    sc = slots.clamp(0, c - 1).long()
    bi = torch.arange(b, device=q.device)[None, :, None, None]
    hi = torch.arange(h, device=q.device)[None, None, :, None]
    k = k_pages[bi, hi, sc].reshape(s * b, h, n * p, d)
    v = v_pages[bi, hi, sc].reshape(s * b, h, n * p, d)
    m, l, o = paged_attention_partial_ref(q.repeat(s, 1, 1), k, v,
                                          valid.reshape(s * b, h, n * p))
    hq = q.shape[1]
    return m.reshape(s, b, hq), l.reshape(s, b, hq), o.reshape(s, b, hq, d)


def merge_partials_ref(m, l, o, axis: int = 0):
    """Merge partials stacked on ``axis`` into one, still unnormalised: the
    global max, each partial rescaled to it, summed. m/l: (N, ...); o:
    (N, ..., D). Associative and commutative up to float reassociation,
    with identity (NEG_INF, 0, 0)."""
    m_g = m.amax(dim=axis)
    corr = torch.exp(m - m_g.unsqueeze(axis))
    l_g = (l * corr).sum(dim=axis)
    o_g = (o * corr[..., None]).sum(dim=axis)
    return m_g, l_g, o_g


def combine_partials_ref(m, l, o, axis: int = 0):
    """The attention output of partials stacked on ``axis``: the merge
    divided by max(l, 1e-30), so a row empty on every partial gives 0.
    m/l: (N, ...); o: (N, ..., D) -> (..., D)."""
    _, l_g, o_g = merge_partials_ref(m, l, o, axis=axis)
    return o_g / l_g.clamp(min=1e-30)[..., None]

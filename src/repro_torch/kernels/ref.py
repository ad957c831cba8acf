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
NEG_INF_HALF = -5e29  # a score at or below it is masked


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
    mask = _flash_mask(sq, sk, causal, window, sink, q_offset, q.device)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = _mm_f32("bhij,bjhd->bihd", p.to(v.dtype), vx)
    return out.to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal: bool = True, window: int = 0,
                            sink: int = 0, q_offset: int = 0):
    """Each row's log-sum-exp of ``flash_attention_ref``'s scaled, masked
    scores: (B, Hq, Sq) f32, natural log, the output the forward kernels
    write for the backward. A row with no allowed key gives -inf (log of an
    empty sum), as the kernels write it, where the reference's uniform
    NEG_INF logits would give about NEG_INF."""
    b, sq, hq, d = q.shape
    group = hq // k.shape[2]
    kx = k.repeat_interleave(group, dim=2) if group > 1 else k
    logits = _mm_f32("bihd,bjhd->bhij", q.to(k.dtype), kx) * _scale(d).to(q.device)
    mask = _flash_mask(sq, k.shape[1], causal, window, sink, q_offset, q.device)
    return torch.logsumexp(torch.where(mask[None, None], logits, -torch.inf), dim=-1)


def _flash_mask(sq: int, sk: int, causal: bool, window: int, sink: int,
                q_offset: int, device):
    """(Sq, Sk) bool: key j attended by query row i (position i + q_offset)."""
    i = torch.arange(sq, device=device)[:, None] + q_offset
    j = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= j <= i
    if window > 0:
        win = j > (i - window)
        if sink > 0:
            win |= j < sink
        mask &= win
    return mask


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True, window: int = 0,
                            sink: int = 0, q_offset: int = 0):
    """The gradients of ``flash_attention_ref`` by the explicit formulas, in
    f32: P = softmax(scale·q·kᵀ) under the same mask, dP = dO·vᵀ,
    Δ = Σ_d dO∘o (from the given output o), dS = P∘(dP − Δ); dq = scale·dS·k,
    dk = scale·dSᵀ·q and dv = Pᵀ·dO, each kv head's summed over its GQA
    group. q, o, do: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D). Returns (dq, dk,
    dv) in the inputs' dtype. P is not rounded to v's dtype, so in bf16 this
    is the gradient of the unrounded function (what the card's backward
    computes); in f32 it equals autograd through ``flash_attention_ref``."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    qf, kf, vf, of, dof = (t.float() for t in (q, k, v, o, do))
    kx = kf.repeat_interleave(group, dim=2) if group > 1 else kf
    vx = vf.repeat_interleave(group, dim=2) if group > 1 else vf
    scale = _scale(d).to(q.device)
    mask = _flash_mask(sq, sk, causal, window, sink, q_offset, q.device)
    p = torch.einsum("bihd,bjhd->bhij", qf, kx) * scale
    p = torch.softmax(torch.where(mask[None, None], p, NEG_INF), dim=-1)
    ds = torch.einsum("bihd,bjhd->bhij", dof, vx)  # dP, then dS in place
    ds -= (dof * of).sum(dim=-1).transpose(1, 2)[..., None]
    ds *= p
    dq = torch.einsum("bhij,bjhd->bihd", ds, kx) * scale
    dk = torch.einsum("bhij,bihd->bjhd", ds, qf) * scale
    del ds
    dv = torch.einsum("bhij,bihd->bjhd", p, dof)
    fold = lambda t: t.reshape(b, sk, hkv, group, d).sum(dim=3)
    return dq.to(q.dtype), fold(dk).to(k.dtype), fold(dv).to(v.dtype)


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


def selectable_pages(page_start, ctx, *, sink: int, local: int, page: int):
    """(B, H, C) bool: the pages a select step may pick, those written and
    past the sink pages and before the first local page,
    n_sink <= page_start // P < max(ctx - local, 0) // P. ``ctx`` is an int
    or a (B,) tensor."""
    n_sink = -(-sink // page) if sink else 0
    if isinstance(ctx, torch.Tensor):
        first_local = (torch.clamp(ctx - local, min=0) // page)[:, None, None]
    else:
        first_local = max(ctx - local, 0) // page
    pidx = torch.where(page_start >= 0, page_start // page, -1)
    return (page_start >= 0) & (pidx >= n_sink) & (pidx < first_local)


def stable_top_k(x, k: int):
    """(values, indices) of the k largest entries along the last dim, equal
    values lower index first, as ``lax.top_k`` orders them."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, order), order


def select_top_k(scores, top_k: int, *, minus_one_masked: bool = False,
                 shards=None):
    """The selection (..., C) scores -> (..., top_k) int32 slots: the
    min(top_k, C) largest by (score descending, slot ascending), padded
    with -1; with ``minus_one_masked``, -1 also where the score is masked
    (<= NEG_INF_HALF). ``shards`` S takes the co-placed layout's two stages
    instead, as the reference's per-device bodies do: each stripe of C/S
    slots keeps its top min(top_k, C/S), and a top-k of their stripe-major
    concatenation picks the selection; it equals the one stage."""
    c = scores.shape[-1]
    if shards is None:
        val, idx = stable_top_k(scores, min(top_k, c))
    else:
        c_loc = c // shards
        k_eff = min(top_k, c_loc)
        v_loc, i_loc = stable_top_k(scores.unflatten(-1, (shards, c_loc)), k_eff)
        i_loc = i_loc + torch.arange(shards, device=scores.device)[:, None] * c_loc
        v_cat, i_cat = v_loc.flatten(-2), i_loc.flatten(-2)
        val, pos = stable_top_k(v_cat, min(top_k, shards * k_eff))
        idx = i_cat.gather(-1, pos)
    if minus_one_masked:
        idx = torch.where(val > NEG_INF_HALF, idx, -1)
    idx = idx.to(torch.int32)
    if idx.shape[-1] < top_k:
        idx = torch.cat([idx, idx.new_full(idx.shape[:-1] + (top_k - idx.shape[-1],),
                                           -1)], dim=-1)
    return idx


def page_select_ref(q, tau_min, tau_max, page_start, ctx, sel_prev, imp_prev,
                    need=None, *, sink: int, local: int, page: int, top_k: int,
                    minus_one_masked: bool = False, shards=None):
    """A retrieval layer's select step: score the selectable pages
    (``page_score_ref``, every other page NEG_INF), select (``select_top_k``),
    add the scores to the importance (a masked page adds 0), and keep the
    previous selection and importance in the rows where ``need`` (B,) bool
    is false (None: every row takes the new ones).

    q (B, Hq, D); tau_min/max (B, H, C, D) f32; page_start (B, H, C) int;
    ctx an int or (B,) tensor; sel_prev (B, H, top_k) int32; imp_prev
    (B, H, C) f32 -> (sel (B, H, top_k) int32, imp (B, H, C) f32)."""
    ok = selectable_pages(page_start, ctx, sink=sink, local=local, page=page)
    scores = torch.where(ok, page_score_ref(q, tau_min, tau_max), NEG_INF)
    sel = select_top_k(scores, top_k, minus_one_masked=minus_one_masked, shards=shards)
    imp = imp_prev + torch.where(scores > NEG_INF_HALF, scores, 0.0)
    if need is not None:
        ns = need[:, None, None]
        sel = torch.where(ns, sel, sel_prev)
        imp = torch.where(ns, imp, imp_prev)
    return sel, imp


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


def gather_pages(k_pages, v_pages, slots):
    """k/v_pages: (B, H, C, P, D); slots: (..., B, H, N) int, clamped into
    [0, C) -> k, v of shape (..., B, H, N*P, D): the pages read in slot order
    (a sentinel reads some page, which the caller's validity masks)."""
    b, h, c, p, d = k_pages.shape
    n = slots.shape[-1]
    sc = slots.clamp(0, c - 1).long()
    bi = torch.arange(b, device=slots.device)[:, None, None]
    hi = torch.arange(h, device=slots.device)[None, :, None]
    shape = (*slots.shape[:-1], n * p, d)
    return k_pages[bi, hi, sc].reshape(shape), v_pages[bi, hi, sc].reshape(shape)


def paged_attention_pages_ref(q, k_pages, v_pages, slots, valid):
    """``paged_attention_ref`` on the pages ``slots`` names: the plain
    version of the kernel that reads them in place. q: (B, Hq, D); k/v_pages:
    (B, Hkv, C, P, D); slots: (B, Hkv, N) int, clamped into [0, C) as
    ``gather_pages`` clamps them; valid: (B, Hkv, N*P) bool."""
    return paged_attention_ref(q, *gather_pages(k_pages, v_pages, slots), valid)


def paged_attention_partial_pages_ref(q, k_pages, v_pages, slots, valid):
    """``paged_attention_partial_ref`` of every page stripe at once, on the
    pages each stripe attends: the plain version of the fused-gather kernel.

    q: (B, Hq, D); k/v_pages: (B, Hkv, C, P, D); slots: (S, B, Hkv, N) int
    page slots of each stripe, -1 where the stripe attends none (it reads
    page 0 there, which ``valid`` masks); valid: (S, B, Hkv, N*P) bool.
    Returns m, l (S, B, Hq) and o (S, B, Hq, D), f32.
    """
    s, b, h, n = slots.shape
    p, d = k_pages.shape[3:]
    k, v = gather_pages(k_pages, v_pages, slots)
    m, l, o = paged_attention_partial_ref(q.repeat(s, 1, 1), k.reshape(s * b, h, n * p, d),
                                          v.reshape(s * b, h, n * p, d),
                                          valid.reshape(s * b, h, n * p))
    hq = q.shape[1]
    return m.reshape(s, b, hq), l.reshape(s, b, hq), o.reshape(s, b, hq, d)


def stripe_slots(slots, valid, *, shards: int, capacity: int):
    """Each stripe's share of an attended slot list: slots (B, H, N) and the
    validity (B, H, N*P) of their buffer -> (S, B, H, N) int32 with -1
    where the stripe does not own the slot (it owns [s·C/S, (s+1)·C/S) of
    the ``capacity`` C page slots), and (S, B, H, N*P) bool. Masking a slot
    to -1 only clears its tokens, so each stripe's validity is the
    buffer's restricted to its slots."""
    n = slots.shape[2]
    stripe = torch.arange(shards, device=slots.device)[:, None, None, None]
    mine = (slots >= 0) & (torch.div(slots, capacity // shards,
                                     rounding_mode="floor") == stripe)
    slots_s = torch.where(mine, slots, -1).to(torch.int32)
    valid_s = valid & mine.repeat_interleave(valid.shape[2] // n, dim=3)
    return slots_s, valid_s


def paged_attention_coplace_ref(q, k_pages, v_pages, slots, valid, shards: int):
    """The co-placed decode over ``shards`` page stripes, as the reference's
    per-device bodies and their combine compute it: each stripe's
    ``paged_attention_partial_pages_ref`` over the slots it owns
    (``stripe_slots``), merged by ``combine_partials_ref``, in q's dtype.
    q: (B, Hq, D); k/v_pages: (B, Hkv, C, P, D); slots: (B, Hkv, N) int;
    valid: (B, Hkv, N*P) bool -> (B, Hq, D)."""
    slots_s, valid_s = stripe_slots(slots, valid, shards=shards,
                                    capacity=k_pages.shape[2])
    m, l, o = paged_attention_partial_pages_ref(q, k_pages, v_pages, slots_s, valid_s)
    return combine_partials_ref(m, l, o).to(q.dtype)


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

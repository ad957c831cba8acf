"""H²EAL hybrid static-dynamic sparse attention (paper §IV-A).

Counterpart of ``repro/core/hybrid_attention.py``: the lockstep path, the
ragged decode of the continuous-batching engine and its chunked prefill.
Per attention layer the KV heads are reordered by a permutation so the
first ``n_retrieval`` are retrieval heads and the rest streaming heads.
``perm=None`` is the identity and skips the reordering (and its index
kernels) altogether; that is what serving passes.

Prefill:  retrieval heads -> full causal flash attention;
          streaming heads -> sink+local flash attention.
Decode:   retrieval heads -> page score -> top-k -> paged attention over
          [sink pages | selected pages | local pages];
          streaming heads -> attention over the sink+local ring buffer.
Selection is recomputed every ``share_window`` steps (``do_select``).
Chunked prefill: a chunk of prompt tokens per slot attends the
          pre-append caches plus the chunk itself (retrieval heads full
          causal, streaming heads sink+local), then is appended.
Co-placed decode (``decode_attention_coplace``, paper §IV-B): the
          ``coplace_shmap`` layout's pages are striped round-robin over S
          stripes, the single-card stand-in for the devices of the JAX
          mesh's 'model' axis; each stripe scores, selects and attends the
          pages it owns and emits flash partials (m, l, o), which a
          log-sum-exp combine merges (a split-KV decode).

The caches are updated in place (see ``repro_torch/core/cache.py``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.configs.base import H2ealConfig
from repro_torch.core import cache as cachelib
from repro_torch.core import paging
from repro_torch.kernels import ops as kops


@dataclass(frozen=True)
class AttnSpec:
    """Static attention-layer spec."""

    n_q: int
    n_kv: int
    head_dim: int
    h2: H2ealConfig
    window: int = 0  # >0: plain sliding-window layer (not ported yet)

    @property
    def group(self) -> int:
        return self.n_q // self.n_kv

    @property
    def n_retrieval(self) -> int:
        if not self.h2.enabled or self.window > 0:
            return self.n_kv
        n_s = round(self.n_kv * self.h2.static_sparsity)
        return max(self.n_kv - n_s, 0)

    @property
    def n_streaming(self) -> int:
        return self.n_kv - self.n_retrieval


def _permute_kv(x, perm):
    """x permuted on its kv-head axis (axis 2 of (B,S,H,D), 1 of (B,H,D))."""
    if perm is None:
        return x
    return x.index_select(2 if x.dim() == 4 else 1, perm.long())


def _permute_q(q, perm, group: int):
    """q: (B, S, Hq, D) or (B, Hq, D): q heads permuted by kv group."""
    if perm is None:
        return q
    shape = q.shape
    axis = q.dim() - 2
    qg = q.reshape(*shape[:axis], shape[axis] // group, group, shape[-1])
    return qg.index_select(axis, perm.long()).reshape(shape)


def _inverse_perm(perm):
    if perm is None:
        return None
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv


def _local_cap(h2: H2ealConfig) -> int:
    # ring capacity: local window + one page of slack so the boundary page
    # semantics match the paged side
    return h2.local + h2.page_size


def _check_ported(spec: AttnSpec) -> None:
    if spec.window > 0:
        raise NotImplementedError(
            "sliding-window attention layers are not ported yet "
            "(ROADMAP Queue 1 item 11)")


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_attention(spec: AttnSpec, q, k, v, perm=None):
    """q: (B,S,Hq,D); k/v: (B,S,Hkv,D) -> (B,S,Hq,D)."""
    _check_ported(spec)
    h2 = spec.h2
    if not h2.enabled or spec.n_streaming == 0:
        return kops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True)
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k, perm)
    vp = _permute_kv(v, perm)
    outs = []
    if nr > 0:
        outs.append(kops.flash_attention(
            qp[:, :, : nr * g].contiguous(), kp[:, :, :nr].contiguous(),
            vp[:, :, :nr].contiguous(), causal=True))
    outs.append(kops.flash_attention(
        qp[:, :, nr * g:].contiguous(), kp[:, :, nr:].contiguous(),
        vp[:, :, nr:].contiguous(), causal=True, window=h2.local,
        sink=h2.sink))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return _permute_q(out, _inverse_perm(perm), g)


def init_decode_state(spec: AttnSpec, k, v, length: int, capacity: int,
                      perm=None, interleave_shards: int = 1):
    """Build (PagedCache, StreamCache) from prefill K/V.

    k/v: (B, S, Hkv, D) post-rope; length == S. capacity: the most
    context tokens the paged cache must hold. ``interleave_shards`` > 1
    lays the pages out striped round-robin over that many stripes
    (physical slot p holds logical page ``paging.logical_pages``[p]).
    """
    _check_ported(spec)
    h2 = spec.h2
    kp = _permute_kv(k, perm)
    vp = _permute_kv(v, perm)
    nr = spec.n_retrieval
    p = h2.page_size
    num_pages = -(-capacity // p)
    s = k.shape[1]
    pad = (-s) % p
    kr, vr = kp[:, :, :nr], vp[:, :, :nr]
    if pad:  # pad the sequence to a page multiple for the paged constructor
        kr = torch.nn.functional.pad(kr, (0, 0, 0, 0, 0, pad))
        vr = torch.nn.functional.pad(vr, (0, 0, 0, 0, 0, pad))
    paged = cachelib.paged_cache_from_prefill(kr, vr, num_pages, p,
                                              h2.top_k_pages)
    if pad:  # recompute the metadata without the pad tokens of the last page
        offs = (torch.arange(num_pages * p, device=k.device) < s).reshape(
            num_pages, p)[None, None, :, :, None]
        kpp = paged.k_pages.float()
        paged.tau_min = torch.where(offs, kpp, float("inf")).amin(dim=3)
        paged.tau_max = torch.where(offs, kpp, float("-inf")).amax(dim=3)
    if interleave_shards > 1:
        if num_pages % interleave_shards:
            raise ValueError(f"page capacity {num_pages} must divide by "
                             f"{interleave_shards} stripes")
        lop = paging.logical_pages(num_pages, interleave_shards, k.device)
        for f in ("k_pages", "v_pages", "tau_min", "tau_max", "importance",
                  "page_start"):
            setattr(paged, f, getattr(paged, f).index_select(2, lop))
    stream = cachelib.stream_cache_from_prefill(
        kp[:, :, nr:], vp[:, :, nr:], sink=h2.sink, local_cap=_local_cap(h2),
        length=length)
    return paged, stream


def empty_decode_state(spec: AttnSpec, batch: int, capacity: int, *, dtype,
                       device):
    """Empty (PagedCache, StreamCache) of ``batch`` slots, the batched
    state the serving engine starts from."""
    _check_ported(spec)
    h2 = spec.h2
    nr, d = spec.n_retrieval, spec.head_dim
    paged = cachelib.make_paged_cache(batch, nr, -(-capacity // h2.page_size),
                                      h2.page_size, d, h2.top_k_pages,
                                      dtype=dtype, device=device)
    stream = cachelib.make_stream_cache(batch, spec.n_streaming, h2.sink,
                                        _local_cap(h2), d, dtype=dtype,
                                        device=device)
    return paged, stream


def chunk_prefill_attention(spec: AttnSpec, q, k_new, v_new,
                            paged: cachelib.PagedCache,
                            stream: cachelib.StreamCache, start, chunk_len,
                            active=None, *, perm=None, phys_shards: int = 1):
    """One chunked-prefill step. q: (B, C, Hq, D) roped at the chunk
    positions; k_new/v_new: (B, C, Hkv, D); start: (B,) int32 context before
    the chunk; chunk_len: (B,) valid tokens; active: (B,) bool, the slots
    prefilling. Returns (out (B, C, Hq, D), paged, stream).

    Each head kind attends BEFORE the chunk is appended: retrieval heads
    the pre-append paged cache plus the chunk (``chunk_attention_paged``,
    full causal, as a single-shot prefill); streaming heads the pre-append
    ring followed by the chunk's keys (``chunk_attention``, sink+local),
    since a chunk longer than the ring's slack overwrites ring slots that
    an early chunk query still attends. No page is selected and the
    selection state is left as it is. Rows past chunk_len and inactive
    slots append nothing; their outputs are finite values the caller
    ignores (an inactive slot attends only its own chunk, so the kernels
    skip its cache). Chunked and single-shot prefill sum in different
    orders, so they agree to float tolerance. ``phys_shards`` > 1 appends
    in the ``coplace_shmap`` striped page order; the attention is the same,
    its validity coming from the page starts.
    """
    _check_ported(spec)
    h2 = spec.h2
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    b, cch = q.shape[:2]
    if active is None:
        active = torch.ones(b, dtype=torch.bool, device=q.device)
    outs = []
    if nr > 0:
        k_r, v_r = kp[:, :, :nr].contiguous(), vp[:, :, :nr].contiguous()
        # a slot that takes no chunk attends no cached key: its rows are
        # ignored, and the kernel then skips its whole cache walk
        outs.append(kops.chunk_attention_paged(
            qp[:, :, : nr * g].contiguous(), paged.k_pages, paged.v_pages,
            paged.page_start, torch.where(active, start, 0), k_r, v_r))
        paged = cachelib.paged_cache_append_chunk(paged, k_r, v_r, start,
                                                  chunk_len, active=active,
                                                  phys_shards=phys_shards)
    if spec.n_streaming > 0:
        ns = spec.n_streaming
        k_s, v_s = kp[:, :, nr:], vp[:, :, nr:]
        kr = torch.cat([stream.k, k_s.transpose(1, 2).to(stream.k.dtype)], dim=2)
        vr = torch.cat([stream.v, v_s.transpose(1, 2).to(stream.v.dtype)], dim=2)
        pos_q = paging.chunk_positions(start, cch)
        kpos = torch.cat([stream.pos, pos_q[:, None, :].expand(b, ns, cch)],
                         dim=2)
        valid_s = paging.chunk_stream_validity(kpos, pos_q, sink=h2.sink,
                                               local=h2.local)
        valid_s &= active[:, None, None, None]  # ignored rows: no key tile runs
        outs.append(kops.chunk_attention(qp[:, :, nr * g:].contiguous(), kr, vr,
                                         valid_s))
        stream = cachelib.stream_cache_append_chunk(
            stream, k_s, v_s, start, chunk_len, sink=h2.sink, active=active)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return _permute_q(out, _inverse_perm(perm), g), paged, stream


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def decode_attention(spec: AttnSpec, q, k_new, v_new,
                     paged: cachelib.PagedCache, stream: cachelib.StreamCache,
                     length, *, do_select: bool, perm=None, active=None,
                     need_select=None):
    """One decode step. q: (B,Hq,D) roped at position ``length`` (the
    context before this token); k_new/v_new: (B,Hkv,D).

    ``length`` is an int on the lockstep path and a (B,) tensor on the
    continuous-batching path, which also passes ``active`` (B,) bool
    (inactive slots append nothing, so their caches stay as they are) and,
    on a select step, ``need_select`` (B,) bool: only those slots take the
    fresh selection and importance, the others keep their cached ones.
    Returns (out (B,Hq,D), paged, stream)."""
    return _decode(spec, _paged_decode, q, k_new, v_new, paged, stream, length,
                   do_select=do_select, perm=perm, active=active,
                   need_select=need_select)


def decode_attention_coplace(spec: AttnSpec, q, k_new, v_new,
                             paged: cachelib.PagedCache,
                             stream: cachelib.StreamCache, length, *,
                             do_select: bool, shards: int, perm=None,
                             active=None, need_select=None):
    """``decode_attention`` with the retrieval heads co-placed over
    ``shards`` page stripes (``_paged_decode_coplace``); the streaming heads
    attend their ring as there. The arguments are those of
    ``decode_attention``; the paged cache is in the striped page order."""
    retrieval = functools.partial(_paged_decode_coplace, shards=shards)
    return _decode(spec, retrieval, q, k_new, v_new, paged, stream, length,
                   do_select=do_select, perm=perm, active=active,
                   need_select=need_select)


def _decode(spec: AttnSpec, retrieval, q, k_new, v_new, paged, stream, length,
            *, do_select: bool, perm, active, need_select):
    """The decode step around a retrieval-head body ``retrieval(spec, q_r,
    k_r, v_r, paged, length, ...) -> (out_r, paged)``."""
    _check_ported(spec)
    h2 = spec.h2
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    q_r, q_s = qp[:, : nr * g].contiguous(), qp[:, nr * g:].contiguous()
    outs = []
    if nr > 0:
        out_r, paged = retrieval(spec, q_r, kp[:, :nr], vp[:, :nr], paged,
                                 length, do_select=do_select, active=active,
                                 need_select=need_select)
        outs.append(out_r)
    if spec.n_streaming > 0:
        stream = cachelib.stream_cache_append(stream, kp[:, nr:], vp[:, nr:],
                                              length, sink=h2.sink,
                                              active=active)
        # exact sink+local mask (the ring carries one page of slack)
        ctx = length + 1
        ctx_b = ctx[:, None, None] if isinstance(ctx, torch.Tensor) else ctx
        valid_s = (stream.pos >= 0) & (
            (stream.pos < h2.sink) | (stream.pos >= ctx_b - h2.local))
        outs.append(kops.paged_attention(q_s, stream.k, stream.v, valid_s))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return _permute_q(out, _inverse_perm(perm), g), paged, stream


def _paged_decode(spec: AttnSpec, q_r, k_r, v_r, paged: cachelib.PagedCache,
                  length, *, do_select: bool, active, need_select):
    """Retrieval heads, single program: append, (select), attend
    [sink | selected | local] pages -> (out (B, HqR, D), paged)."""
    h2 = spec.h2
    ctx = length + 1
    _, n_local = paging.page_counts(sink=h2.sink, local=h2.local,
                                    page=h2.page_size)
    if not isinstance(ctx, torch.Tensor) and (
            paging.first_local_page(ctx, local=h2.local, page=h2.page_size)
            + n_local > paged.k_pages.shape[2]):
        raise ValueError(
            f"context {ctx} needs more pages than the cache's "
            f"{paged.k_pages.shape[2]}: serve with capacity >= context + "
            f"page_size")
    paged = cachelib.paged_cache_append(paged, k_r, v_r, length, active)
    if do_select:
        scores = paging.score_pages(
            q_r, paged.tau_min, paged.tau_max, paged.page_start, ctx,
            sink=h2.sink, local=h2.local, page=h2.page_size)
        sel = paging.select_pages(scores, h2.top_k_pages)
        imp = paging.accumulate_importance(paged.importance, scores)
        _keep_selection(paged, sel, imp, need_select)
    slots = paging.attended_page_slots(
        paged.sel_idx, ctx, sink=h2.sink, local=h2.local, page=h2.page_size)
    gk, gv = paging.gather_pages(paged.k_pages, paged.v_pages, slots)
    valid = paging.token_validity(
        slots, paged.page_start, ctx, sink=h2.sink, local=h2.local,
        page=h2.page_size, top_k=h2.top_k_pages)
    return kops.paged_attention(q_r, gk, gv, valid), paged


def _keep_selection(paged: cachelib.PagedCache, sel, imp, need_select):
    """Store a select step's selection and importance; under the engine's
    per-slot share window only the slots in ``need_select`` take them."""
    if need_select is not None:
        ns = need_select[:, None, None]
        sel = torch.where(ns, sel, paged.sel_idx)
        imp = torch.where(ns, imp, paged.importance)
    paged.sel_idx, paged.importance = sel, imp


NEG_INF_HALF = -5e29


def _paged_decode_coplace(spec: AttnSpec, q_r, k_r, v_r,
                          paged: cachelib.PagedCache, length, *,
                          do_select: bool, shards: int, active, need_select):
    """Retrieval heads under co-placement over ``shards`` page stripes: the
    reference's per-device body (``_paged_decode_coplace``, one shard_map
    program per device of the 'model' axis) batched over a stripe axis of
    one tensor. Stripe s owns the physical page slots [s·C/S, (s+1)·C/S).

      append      the token goes to its page's striped slot;
      select      page_score over all C slots at once, viewed (B, Hr, S,
                  C/S); the importance accumulates every score; each stripe
                  keeps its top k_eff = min(K, C/S) (lower slot first among
                  equal scores, as ``lax.top_k``), as physical ids; a global
                  top-K over the stripe-major concatenation; -1 where the
                  score is masked (<= NEG_INF_HALF) and as padding to K;
      attend      the [sink | selected | local] slots, each kept only on the
                  stripe that owns it (-1 elsewhere), with the validity of
                  the unsplit buffer; one partial-attention launch over
                  every stripe, one combine launch, cast to q's dtype.

    No step reads from the card. Returns (out (B, HqR, D), paged).
    """
    h2 = spec.h2
    p_sz, top_k = h2.page_size, h2.top_k_pages
    b, hr, cap = paged.k_pages.shape[:3]
    nsh = shards
    if cap % nsh:
        raise ValueError(f"page capacity {cap} must divide by {nsh} stripes: "
                         f"round the capacity up to page_size * stripes")
    c_loc = cap // nsh
    ctx = length + 1
    paged = cachelib.paged_cache_append(paged, k_r, v_r, length, active,
                                        phys_shards=nsh)
    if do_select:
        scores = paging.score_pages(
            q_r, paged.tau_min, paged.tau_max, paged.page_start, ctx,
            sink=h2.sink, local=h2.local, page=p_sz)      # (B, Hr, C)
        imp = paging.accumulate_importance(paged.importance, scores)
        k_eff = min(top_k, c_loc)
        v_loc, i_loc = paging.top_k(scores.view(b, hr, nsh, c_loc), k_eff)
        base = torch.arange(nsh, device=scores.device)[:, None] * c_loc
        v_cat = v_loc.reshape(b, hr, nsh * k_eff)
        i_cat = (i_loc + base).reshape(b, hr, nsh * k_eff)
        sel_v, sel_pos = paging.top_k(v_cat, min(top_k, nsh * k_eff))
        sel = torch.where(sel_v > NEG_INF_HALF, i_cat.gather(2, sel_pos), -1)
        _keep_selection(paged, paging.pad_selection(sel, top_k), imp,
                        need_select)
    slots = paging.coplace_attended_slots(
        paged.sel_idx, ctx, sink=h2.sink, local=h2.local, page=p_sz,
        capacity=cap, n_shards=nsh)                       # (B, Hr, N)
    valid = paging.token_validity(
        slots, paged.page_start, ctx, sink=h2.sink, local=h2.local, page=p_sz,
        top_k=top_k)                                      # (B, Hr, N*P)
    slots_s, valid_s = stripe_slots(slots, valid, shards=nsh, capacity=cap)
    m, l, o = kops.paged_attention_partial(q_r, paged.k_pages, paged.v_pages,
                                           slots_s, valid_s)
    return kops.combine_partials(m, l, o).to(q_r.dtype), paged


def stripe_slots(slots, valid, *, shards: int, capacity: int):
    """Each stripe's share of an attended slot list: slots (B, H, N) and the
    validity (B, H, N*P) of their buffer -> (S, B, H, N) int32 with -1
    where the stripe does not own the slot (it owns [s·C/S, (s+1)·C/S)),
    and (S, B, H, N*P) bool. Masking a slot to -1 only clears its tokens,
    so each stripe's validity is the buffer's restricted to its slots."""
    n = slots.shape[2]
    stripe = torch.arange(shards, device=slots.device)[:, None, None, None]
    mine = (slots >= 0) & (torch.div(slots, capacity // shards,
                                     rounding_mode="floor") == stripe)
    slots_s = torch.where(mine, slots, -1).to(torch.int32)
    valid_s = valid & mine.repeat_interleave(valid.shape[2] // n, dim=3)
    return slots_s, valid_s


def full_decode_attention(spec: AttnSpec, q, k_new, v_new,
                          cache: cachelib.FullCache, length, active=None):
    """Full-attention baseline decode step (H²EAL disabled); ``length`` an
    int or a (B,) tensor, as in ``decode_attention``."""
    _check_ported(spec)
    cache = cachelib.full_cache_append(cache, k_new, v_new, length, active)
    b, h, s, _ = cache.k.shape
    pos = torch.arange(s, device=q.device)
    lb = length[:, None, None] if isinstance(length, torch.Tensor) else length
    valid = (pos < lb + 1).expand(b, h, s).contiguous()
    return kops.paged_attention(q.contiguous(), cache.k, cache.v, valid), cache

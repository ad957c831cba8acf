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
Speculative verify (``chunk_verify_attention``): k drafted tokens as k
          decode steps in one chunk over the pre-append caches, then the
          accepted prefix appended (``chunk_verify_append``).
Eviction pool (``decode_attention_pool``, paper §IV-A.3): decode against
          a fixed pool of page slots, the lowest-importance page
          overwritten once it is full (lockstep only, as in the reference).
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
from repro_torch.kernels import ref as kref


@dataclass(frozen=True)
class AttnSpec:
    """Static attention-layer spec."""

    n_q: int
    n_kv: int
    head_dim: int
    h2: H2ealConfig
    window: int = 0  # >0: plain sliding-window layer (gemma3's local layers)
    # a chunk step computes the rows of the slots that take no chunk as the
    # reference does (their cache walked, their ring keys valid), where they
    # feed a mixture of experts whose capacity counts them; otherwise the
    # kernels skip those rows, whose values nothing reads
    idle_rows: bool = False

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


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_attention(spec: AttnSpec, q, k, v, perm=None):
    """q: (B,S,Hq,D); k/v: (B,S,Hkv,D) -> (B,S,Hq,D). A sliding-window
    layer attends its window (no sink), every head alike."""
    h2 = spec.h2
    if spec.window > 0:
        return kops.flash_attention(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=True,
                                    window=spec.window)
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
    skip its cache), unless ``spec.idle_rows``: then they are the
    reference's values, which a capacity-bound MoE layer routes. Chunked
    and single-shot prefill sum in different orders, so they agree to
    float tolerance. ``phys_shards`` > 1 appends
    in the ``coplace_shmap`` striped page order; the attention is the same,
    its validity coming from the page starts.
    """
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
        # a slot that takes no chunk attends no cached key (unless its rows
        # are routed): the kernel then skips its whole cache walk
        attended = start if spec.idle_rows else torch.where(active, start, 0)
        outs.append(kops.chunk_attention_paged(
            qp[:, :, : nr * g].contiguous(), paged.k_pages, paged.v_pages,
            paged.page_start, attended, k_r, v_r))
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
        if not spec.idle_rows:
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
    [sink | selected | local] pages, read in place through their slots (no
    gathered copy) -> (out (B, HqR, D), paged)."""
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
        _select(h2, q_r, paged, ctx, need_select)
    slots = paging.attended_page_slots(
        paged.sel_idx, ctx, sink=h2.sink, local=h2.local, page=h2.page_size)
    valid = paging.token_validity(
        slots, paged.page_start, ctx, sink=h2.sink, local=h2.local,
        page=h2.page_size, top_k=h2.top_k_pages)
    return kops.paged_attention_pages(q_r, paged.k_pages, paged.v_pages, slots,
                                      valid), paged


def decode_attention_pool(spec: AttnSpec, q, k_new, v_new,
                          paged: cachelib.PagedCache, stream: cachelib.StreamCache,
                          length: int, *, do_select: bool, perm=None):
    """Decode against a FIXED pool of C page slots (``kv_budget`` tokens; paper
    §IV-A.3): once the pool is full, a new page overwrites the live page of
    lowest accumulated importance, sink and local pages protected
    (``cache.pool_append``). Slots hold pages in any order, so the sink and
    local pages are found by their starts (``paging.slots_of_positions``,
    -1 where a page is not resident) and the selection scores whatever the
    slots hold. The lockstep path only: ``length`` is a Python int, the
    context before this token. The kernels are the main path's: one
    ``kops.page_select`` a select step (ties by slot, as ``lax.top_k`` on
    the pool), then ``kops.paged_attention_pages`` over the [sink | selected
    | local] slots read in place. Returns (out (B,Hq,D), paged, stream)."""
    h2 = spec.h2
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    ctx, p_sz = length + 1, h2.page_size
    outs = []
    if nr > 0:
        q_r = qp[:, : nr * g].contiguous()
        paged = cachelib.pool_append(paged, kp[:, :nr], vp[:, :nr], length,
                                     page=p_sz, sink=h2.sink, local=h2.local)
        if do_select:
            _select(h2, q_r, paged, ctx, None)
        n_sink, n_local = paging.page_counts(sink=h2.sink, local=h2.local,
                                             page=p_sz)
        first_local = paging.first_local_page(ctx, local=h2.local, page=p_sz)
        dev = q.device
        sink_pos = torch.arange(n_sink, dtype=torch.int32, device=dev) * p_sz
        local_pos = (first_local + torch.arange(n_local, dtype=torch.int32,
                                                device=dev)) * p_sz
        slots = torch.cat([paging.slots_of_positions(paged.page_start, sink_pos),
                           paged.sel_idx,
                           paging.slots_of_positions(paged.page_start, local_pos)],
                          dim=2)
        valid = paging.token_validity(slots, paged.page_start, ctx, sink=h2.sink,
                                      local=h2.local, page=p_sz, top_k=h2.top_k_pages)
        outs.append(kops.paged_attention_pages(q_r, paged.k_pages, paged.v_pages,
                                               slots, valid))
    if spec.n_streaming > 0:
        stream = cachelib.stream_cache_append(stream, kp[:, nr:], vp[:, nr:],
                                              length, sink=h2.sink)
        valid_s = (stream.pos >= 0) & (
            (stream.pos < h2.sink) | (stream.pos >= ctx - h2.local))
        outs.append(kops.paged_attention(qp[:, nr * g:].contiguous(), stream.k,
                                         stream.v, valid_s))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return _permute_q(out, _inverse_perm(perm), g), paged, stream


def _select(h2, q_r, paged: cachelib.PagedCache, ctx, need_select,
            minus_one_masked: bool = False):
    """A select step in one ``kops.page_select``: score the selectable
    pages, take the stable top-k, add the scores to the importance; under
    the engine's per-slot share window only the slots in ``need_select``
    take the new selection and importance."""
    paged.sel_idx, paged.importance = kops.page_select(
        q_r, paged.tau_min, paged.tau_max, paged.page_start, ctx, paged.sel_idx,
        paged.importance, need_select, sink=h2.sink, local=h2.local,
        page=h2.page_size, top_k=h2.top_k_pages, minus_one_masked=minus_one_masked)


def _paged_decode_coplace(spec: AttnSpec, q_r, k_r, v_r,
                          paged: cachelib.PagedCache, length, *,
                          do_select: bool, shards: int, active, need_select):
    """Retrieval heads under co-placement over ``shards`` page stripes: the
    reference's per-device body (``_paged_decode_coplace``, one shard_map
    program per device of the 'model' axis) batched over a stripe axis of
    one tensor. Stripe s owns the physical page slots [s·C/S, (s+1)·C/S).

      append      the token goes to its page's striped slot;
      select      the reference scores each stripe's C/S slots, keeps each
                  stripe's top k_eff = min(K, C/S) (lower slot first among
                  equal scores, as ``lax.top_k``) as physical ids, and takes
                  a global top-K of their stripe-major concatenation, -1
                  where the score is masked and as padding to K. Stripe s
                  owns the slots [s·C/S, (s+1)·C/S), and every page of the
                  global top-K is in its stripe's top-k_eff, so that is one
                  stable top-K over all C slots (``ref.select_top_k``): one
                  ``kops.page_select`` with ``minus_one_masked``;
      attend      the [sink | selected | local] slots and the validity of
                  the unsplit buffer; each stripe attends the pages it owns,
                  and the stripes' partials are combined, in q's dtype: one
                  launch (``kops.paged_attention_coplace``).

    No step reads from the card. Returns (out (B, HqR, D), paged).
    """
    h2 = spec.h2
    p_sz, top_k = h2.page_size, h2.top_k_pages
    cap = paged.k_pages.shape[2]
    nsh = shards
    if cap % nsh:
        raise ValueError(f"page capacity {cap} must divide by {nsh} stripes: "
                         f"round the capacity up to page_size * stripes")
    ctx = length + 1
    paged = cachelib.paged_cache_append(paged, k_r, v_r, length, active,
                                        phys_shards=nsh)
    if do_select:
        _select(h2, q_r, paged, ctx, need_select, minus_one_masked=True)
    slots = paging.coplace_attended_slots(
        paged.sel_idx, ctx, sink=h2.sink, local=h2.local, page=p_sz,
        capacity=cap, n_shards=nsh)                       # (B, Hr, N)
    valid = paging.token_validity(
        slots, paged.page_start, ctx, sink=h2.sink, local=h2.local, page=p_sz,
        top_k=top_k)                                      # (B, Hr, N*P)
    return kops.paged_attention_coplace(q_r, paged.k_pages, paged.v_pages, slots,
                                        valid, nsh), paged


# ---------------------------------------------------------------------------
# Speculative verify: k decode steps in one chunked pass
# ---------------------------------------------------------------------------


def chunk_verify_attention(spec: AttnSpec, q, k_new, v_new,
                           paged: cachelib.PagedCache,
                           stream: cachelib.StreamCache, start, active=None,
                           need_select=None, *, perm=None, phys_shards: int = 1,
                           minus_one_masked: bool = False):
    """Verify k drafted tokens: each chunk query attends exactly what its
    sequential decode step would, and neither the KV pages nor the ring
    change (attend-before-append: ``chunk_verify_append`` later commits the
    accepted prefix, so the τ min/max merge, which cannot be undone, never
    needs undoing). q: (B, k, Hq, D) roped at start .. start+k-1; k_new /
    v_new: (B, k, Hkv, D); start: (B,) int32 context before the chunk.
    Returns (out (B, k, Hq, D), paged, stream); of the paged cache only the
    selection and importance change, and only for the slots in
    ``need_select & active`` (the others keep theirs, as on a reuse step).

    Selection is scored once a chunk, with query 0 at context start+1: the
    query, context and τ of the sequential select step (the page taking
    position start is never selectable), so the fresh selection is that
    step's. One ``kops.page_select``, ``minus_one_masked`` as the layout's
    decode passes it. The engine clamps acceptance at the share-window
    boundary, so no refresh falls inside a chunk. Retrieval heads attend the
    gathered [sink | selected | local] pages (``paging.verify_token_validity``
    sections them per query) followed by the chunk's own keys under a causal
    triangle; streaming heads the ring followed by the chunk's keys
    (``chunk_stream_validity``); both through ``kops.chunk_attention``.
    ``phys_shards`` > 1 lays the fixed sections out in the ``coplace_shmap``
    striped page order."""
    h2 = spec.h2
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    b, kch = q.shape[:2]
    dev = q.device
    act = torch.ones(b, dtype=torch.bool, device=dev) if active is None else active
    need = torch.ones(b, dtype=torch.bool, device=dev) if need_select is None \
        else need_select
    start = start.reshape(b).to(torch.int32)
    pos_q = paging.chunk_positions(start, kch)
    outs = []
    if nr > 0:
        q_r = qp[:, :, : nr * g].contiguous()
        _select(h2, q_r[:, 0].contiguous(), paged, start + 1, need & act,
                minus_one_masked=minus_one_masked)
        slots = paging.verify_attended_slots(
            paged.sel_idx, start + 1, sink=h2.sink, local=h2.local,
            page=h2.page_size, capacity=paged.k_pages.shape[2],
            n_shards=phys_shards)
        gk, gv = kref.gather_pages(paged.k_pages, paged.v_pages, slots)
        valid_p = paging.verify_token_validity(
            slots, paged.page_start, start, pos_q, sink=h2.sink, local=h2.local,
            page=h2.page_size, top_k=h2.top_k_pages)
        kr = torch.cat([gk, kp[:, :, :nr].transpose(1, 2).to(gk.dtype)], dim=2)
        vr = torch.cat([gv, vp[:, :, :nr].transpose(1, 2).to(gv.dtype)], dim=2)
        tail = torch.ones(kch, kch, dtype=torch.bool, device=dev).tril()
        valid = torch.cat([valid_p, tail.expand(b, nr, kch, kch)], dim=3)
        outs.append(kops.chunk_attention(q_r, kr, vr, valid))
    if spec.n_streaming > 0:
        ns = spec.n_streaming
        kr = torch.cat([stream.k, kp[:, :, nr:].transpose(1, 2).to(stream.k.dtype)],
                       dim=2)
        vr = torch.cat([stream.v, vp[:, :, nr:].transpose(1, 2).to(stream.v.dtype)],
                       dim=2)
        kpos = torch.cat([stream.pos, pos_q[:, None, :].expand(b, ns, kch)], dim=2)
        valid_s = paging.chunk_stream_validity(kpos, pos_q, sink=h2.sink,
                                               local=h2.local)
        outs.append(kops.chunk_attention(qp[:, :, nr * g:].contiguous(), kr, vr,
                                         valid_s))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return _permute_q(out, _inverse_perm(perm), g), paged, stream


def chunk_verify_append(spec: AttnSpec, k_new, v_new, paged: cachelib.PagedCache,
                        stream: cachelib.StreamCache, start, accepted,
                        active=None, *, perm=None, phys_shards: int = 1):
    """Commit the accepted prefix (``accepted`` (B,) >= 1 tokens) of a
    verified chunk, k_new/v_new (B, k, Hkv, D) roped, into the caches in
    place: the chunk appends of chunked prefill with chunk_len = accepted,
    the scatter and τ min/max merge that the same tokens appended one at a
    time would leave. Returns (paged, stream)."""
    h2 = spec.h2
    nr = spec.n_retrieval
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    if nr > 0:
        paged = cachelib.paged_cache_append_chunk(
            paged, kp[:, :, :nr], vp[:, :, :nr], start, accepted, active=active,
            phys_shards=phys_shards)
    if spec.n_streaming > 0:
        stream = cachelib.stream_cache_append_chunk(
            stream, kp[:, :, nr:], vp[:, :, nr:], start, accepted, sink=h2.sink,
            active=active)
    return paged, stream


def full_decode_attention(spec: AttnSpec, q, k_new, v_new,
                          cache: cachelib.FullCache, length, active=None):
    """Decode step of a layer with a full cache: the full-attention baseline
    (H²EAL disabled) or a sliding-window layer, which attends the last
    ``spec.window`` positions; ``length`` an int or a (B,) tensor, as in
    ``decode_attention``."""
    cache = cachelib.full_cache_append(cache, k_new, v_new, length, active)
    b, h, s, _ = cache.k.shape
    pos = torch.arange(s, device=q.device)
    lb = length[:, None, None] if isinstance(length, torch.Tensor) else length
    valid = pos < lb + 1
    if spec.window > 0:
        valid = valid & (pos > lb - spec.window)
    valid = valid.expand(b, h, s).contiguous()
    return kops.paged_attention(q.contiguous(), cache.k, cache.v, valid), cache

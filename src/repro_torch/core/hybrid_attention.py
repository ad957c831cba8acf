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
GSPMD layouts (``decode_attention_placed``, ``chunk_prefill_attention_placed``,
          ``chunk_verify_attention_placed`` / ``chunk_verify_append_placed``,
          ``full_decode_attention_placed`` / ``full_chunk_attention_placed``):
          the steps above on one rank's blocks of the caches, gathering
          over the rank's mesh where GSPMD would (see their section); the
          same steps serve ``coplace_shmap`` on a mesh, its stripes the
          ranks of 'model'.

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
from repro_torch.runtime import collectives as coll


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
    def full_cache(self) -> bool:
        """A window layer, or the full-attention baseline (H²EAL off), keeps
        a ``FullCache`` instead of the paged and streaming caches."""
        return not self.h2.enabled or self.window > 0

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
# The GSPMD layouts (head, coplace, interleave): one rank's block
#
# The reference runs the default decode body and lets GSPMD partition it by
# the caches' placement. Here each rank holds its block of every cache leaf
# (``cache.Placement``) and computes on it, with an explicit gather where
# GSPMD inserts its own collectives (``runtime/collectives``):
#
#   append   the owner of the token's tile writes (``cache.paged_block_append``);
#   select   on the rank's τ tile. Where τ's pages are cut over 'model'
#            (coplace), each rank keeps the top min(K, C/M) of its pages, the
#            candidates (scores, global slots) are gathered, and every rank
#            takes the same stable top-K of their rank-major concatenation:
#            one stable top-K over all C pages, as the reference selects
#            (``ref.select_top_k``'s two stages). Kv heads cut over 'model'
#            (head) gather the selections, which the reference keeps whole;
#   attend   ``head``: the page-table decode on the rank's heads;
#            ``coplace`` / ``interleave``: ``paged_attention_partial`` over
#            the rank's pages (and token stripe) among the [sink | selected
#            | local] slots, the partials (m, l, o) gathered over the axes
#            that cut the pages and merged by ``combine_partials``;
#   ring     the streaming heads, over 'model' in every layout, attend their
#            own ring;
#   verify   the speculative chunk selects as the decode does, at query 0;
#            the retrieval heads' [sink | selected | local] buffer of the
#            rank's rows and heads is filled by the owners of its tokens and
#            summed over the ranks that cut the pages (one collective, each
#            token from its one owner), then attended with the chunk's keys;
#            the accepted prefix is appended owner-only;
#   full     a full cache (a window layer, H²EAL off), its rows over the
#            batch axes and kv heads over 'model' where they divide: the
#            default body on the rank's rows and heads
#            (``full_decode_attention_placed`` / ``full_chunk_attention_placed``).
#
# ``coplace_shmap`` on a mesh is ``coplace``'s placement in the striped
# physical page order (``Placement.stripes``): rank r of 'model' holds
# stripe r, as each device of the reference's shard_map body does. The
# appends go to the page's striped slot; the select keeps physical slots
# and turns a masked selected page into -1 (``Placement.minus_one``); the
# [sink | selected | local] slots are ``paging.coplace_attended_slots``.
# The steps are otherwise the ones above: each rank attends its stripe's
# pages by partials merged by ``combine_partials`` over 'model', the
# reference's per-device partials and cross-device combine.
#
# The outputs of kv heads and batch rows cut over an axis are gathered, so
# every rank ends the layer with the whole batch's attention output. The
# batch is the engine's: lengths are (B,) tensors (no lockstep path).
# ---------------------------------------------------------------------------


def _gather_dim(x, mesh, axes, dim: int):
    """Blocks of ``x`` cut over ``axes`` (most significant first) along
    ``dim``, gathered into the whole dimension."""
    for a in reversed(axes):
        x = coll.gather(x, mesh, a, dim)
    return x


def _gather_out(out, place: cachelib.Placement, key: str, field: str, head_dim: int):
    """An attention output computed on a leaf's batch rows and kv heads,
    gathered over the axes that cut them (heads on ``head_dim``, rows on 0)."""
    out = _gather_dim(out, place.mesh, place.axes(key, field, 1), head_dim)
    return _gather_dim(out, place.mesh, place.axes(key, field, 0), 0)


def _require_ragged(length):
    if not isinstance(length, torch.Tensor):
        raise NotImplementedError(
            "the GSPMD layouts step (B,) lengths, an int is refused: lockstep "
            "generate on a mesh (ROADMAP Queue 1 item 9c) makes its state so "
            "(runtime/serve.make_lockstep_prefill)")


def decode_attention_placed(spec: AttnSpec, q, k_new, v_new,
                            paged: cachelib.PagedCache,
                            stream: cachelib.StreamCache, length, *,
                            do_select: bool, place: cachelib.Placement,
                            perm=None, active=None, need_select=None):
    """``decode_attention`` on one rank's block of a GSPMD layout. q, k_new,
    v_new, length (B,), active and need_select are the whole batch's (the
    layer is replicated); ``paged`` and ``stream`` the rank's blocks.
    Returns (out (B, Hq, D), paged, stream), ``out`` the same on every rank."""
    _require_ragged(length)
    g = spec.group
    nr = spec.n_retrieval
    b = q.shape[0]
    act = cachelib._active(active, b, q.device)
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    outs = []
    if nr > 0:
        outs.append(_placed_retrieval_decode(
            spec, qp[:, : nr * g], kp[:, :nr], vp[:, :nr], paged, length,
            do_select=do_select, place=place, active=act, need_select=need_select))
    if spec.n_streaming > 0:
        outs.append(_placed_ring_decode(spec, qp[:, nr * g:], kp[:, nr:],
                                        vp[:, nr:], stream, length, place, act))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return _permute_q(out, _inverse_perm(perm), g), paged, stream


def _placed_ring_decode(spec: AttnSpec, q_s, k_s, v_s, stream, length, place, act):
    """The streaming heads on the rank's ring block: append, attend the
    sink+local keys, gather the output."""
    h2, g = spec.h2, spec.group
    (b0, b1), (h0, h1) = place.bounds[("stream", "k")][:2]
    r = slice(b0, b1)
    stream = cachelib.stream_cache_append(stream, k_s[r, h0:h1], v_s[r, h0:h1],
                                          length[r], sink=h2.sink, active=act[r])
    ctx = (length[r] + 1)[:, None, None]
    valid = (stream.pos >= 0) & ((stream.pos < h2.sink) | (stream.pos >= ctx - h2.local))
    out = kops.paged_attention(q_s[r, h0 * g:h1 * g].contiguous(), stream.k, stream.v,
                               valid)
    return _gather_out(out, place, "stream", "k", 1)


def _placed_select(h2, q_r, paged: cachelib.PagedCache, ctx, need_select, place,
                   group: int):
    """A select step on the rank's τ tile (see the section comment)."""
    top_k = h2.top_k_pages
    (t0, t1), (th0, th1), (tc0, tc1) = place.bounds[("paged", "tau_min")][:3]
    (s0, s1) = place.bounds[("paged", "sel_idx")][0]
    r = slice(t0, t1)
    q_t = q_r[r, th0 * group:th1 * group].contiguous()
    ctx_t = ctx[r].to(torch.int32)
    need_t = None if need_select is None else need_select[r]
    # the previous selection of the τ tile's rows and heads; rows outside the
    # selection's own tile (interleave's replicated τ over a cut batch) are
    # computed and dropped
    prev = torch.zeros((t1 - t0, th1 - th0, top_k), dtype=torch.int32, device=q_r.device)
    prev[s0 - t0:s1 - t0] = paged.sel_idx[:, th0:th1]
    if not place.cut("paged", "tau_min", 2):
        sel, imp = kops.page_select(
            q_t, paged.tau_min, paged.tau_max, paged.page_start, ctx_t, prev,
            paged.importance, need_t, sink=h2.sink, local=h2.local, page=h2.page_size,
            top_k=top_k, minus_one_masked=place.minus_one)
    else:
        # pages cut over 'model': each rank's top min(K, C/M), then one
        # stable top-K of the gathered candidates
        ok = kref.selectable_pages(paged.page_start, ctx_t, sink=h2.sink,
                                   local=h2.local, page=h2.page_size)
        scores = torch.where(ok, kops.page_score(q_t, paged.tau_min, paged.tau_max),
                             kref.NEG_INF)
        imp = paged.importance + torch.where(scores > kref.NEG_INF_HALF, scores, 0.0)
        k_eff = min(top_k, tc1 - tc0)
        v_loc, i_loc = kref.stable_top_k(scores, k_eff)
        (axis,) = place.cut("paged", "tau_min", 2)
        cand_v = coll.stack(v_loc, place.mesh, axis)              # (M, Bt, Ht, k_eff)
        cand_i = coll.stack(i_loc + tc0, place.mesh, axis)
        m = cand_v.shape[0]
        v_cat = cand_v.permute(1, 2, 0, 3).reshape(t1 - t0, th1 - th0, m * k_eff)
        i_cat = cand_i.permute(1, 2, 0, 3).reshape(t1 - t0, th1 - th0, m * k_eff)
        v_sel, pos = kref.stable_top_k(v_cat, min(top_k, m * k_eff))
        sel = i_cat.gather(-1, pos).to(torch.int32)
        if place.minus_one:
            sel = torch.where(v_sel > kref.NEG_INF_HALF, sel, -1)
        if sel.shape[-1] < top_k:
            sel = torch.cat([sel, sel.new_full(sel.shape[:-1] + (top_k - sel.shape[-1],),
                                               -1)], dim=-1)
        if need_t is not None:
            sel = torch.where(need_t[:, None, None], sel, prev)
            imp = torch.where(need_t[:, None, None], imp, paged.importance)
    sel = _gather_dim(sel, place.mesh, place.axes("paged", "tau_min", 1), 1)
    paged.sel_idx = sel[s0 - t0:s1 - t0]
    paged.importance = imp


def _placed_slots(h2, sel, ctx, place):
    """The [sink | selected | local] slots (B, H, N) of the full cache in the
    layout's physical page order (the striped order under
    ``place.stripes``, its fixed sections clipped to the last page)."""
    return paging.verify_attended_slots(sel, ctx, sink=h2.sink, local=h2.local,
                                        page=h2.page_size,
                                        capacity=place.shapes[("paged", "k_pages")][2],
                                        n_shards=place.stripes)


def _placed_retrieval_decode(spec: AttnSpec, q_r, k_r, v_r, paged, length, *,
                             do_select: bool, place, active, need_select):
    """Retrieval heads on the rank's blocks: append, (select), attend,
    gather (see the section comment)."""
    h2, g = spec.h2, spec.group
    p_sz = h2.page_size
    ctx = length + 1
    cachelib.paged_block_append(paged, k_r, v_r, length, active, place)
    if do_select:
        _placed_select(h2, q_r, paged, ctx, need_select, place, g)
    (b0, b1), (h0, h1), (c0, c1), (p0, p1), _ = place.bounds[("paged", "k_pages")]
    (m0, _), (mh0, _), (mc0, mc1) = place.bounds[("paged", "page_start")]
    (s0, _) = place.bounds[("paged", "sel_idx")][0]
    r = slice(b0, b1)
    ctx_b = ctx[r]
    slots = _placed_slots(h2, paged.sel_idx[b0 - s0:b1 - s0, h0:h1], ctx_b, place)
    page_start = paged.page_start[b0 - m0:b1 - m0, h0 - mh0:h1 - mh0]
    valid = paging.token_validity(paging.block_slots(slots, mc0, mc1), page_start,
                                  ctx_b, sink=h2.sink, local=h2.local, page=p_sz,
                                  top_k=h2.top_k_pages)                # (Bl, Hl, N*P)
    q_b = q_r[r, h0 * g:h1 * g].contiguous()
    if not place.partials:
        out = kops.paged_attention_pages(q_b, paged.k_pages, paged.v_pages,
                                         paging.block_slots(slots, c0, c1), valid)
        return _gather_out(out, place, "paged", "k_pages", 1)
    local = paging.block_slots(slots, c0, c1)                           # (Bl, Hl, N)
    bl, hl, n = local.shape
    valid = (valid.reshape(bl, hl, n, p_sz) & (local >= 0)[..., None])[..., p0:p1]
    m, l, o = kops.paged_attention_partial(q_b, paged.k_pages, paged.v_pages,
                                           local[None], valid.reshape(1, bl, hl, -1))
    # the partials of every rank whose pages (or token stripes) differ
    for dim in (3, 2):
        for axis in reversed(place.axes("paged", "k_pages", dim)):
            m, l, o = (coll.stack(x, place.mesh, axis).flatten(0, 1) for x in (m, l, o))
    out = kops.combine_partials(m, l, o).to(q_r.dtype)
    return _gather_out(out, place, "paged", "k_pages", 1)


def chunk_prefill_attention_placed(spec: AttnSpec, q, k_new, v_new,
                                   paged: cachelib.PagedCache,
                                   stream: cachelib.StreamCache, start, chunk_len,
                                   active=None, *, place: cachelib.Placement,
                                   perm=None):
    """``chunk_prefill_attention`` on one rank's block of a GSPMD layout. The
    chunk kernels take whole caches, so where pages (or token stripes) are
    cut the rank gathers its rows' and heads' pages of this layer first, as
    GSPMD gathers around a custom call; then it attends its rows and heads,
    appends into its block, and gathers the outputs. Returns (out (B, C, Hq,
    D), paged, stream), ``out`` the same on every rank."""
    h2 = spec.h2
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    b, cch = q.shape[:2]
    act = cachelib._active(active, b, q.device)
    mesh = place.mesh
    outs = []
    if nr > 0:
        (b0, b1), (h0, h1) = place.bounds[("paged", "k_pages")][:2]
        (m0, _), (mh0, _) = place.bounds[("paged", "page_start")][:2]
        r = slice(b0, b1)
        k_pages, v_pages = paged.k_pages, paged.v_pages
        for dim in (3, 2):
            k_pages = _gather_dim(k_pages, mesh, place.axes("paged", "k_pages", dim), dim)
            v_pages = _gather_dim(v_pages, mesh, place.axes("paged", "v_pages", dim), dim)
        page_start = _gather_dim(paged.page_start[b0 - m0:b1 - m0, h0 - mh0:h1 - mh0],
                                 mesh, place.axes("paged", "page_start", 2), 2)
        attended = start[r] if spec.idle_rows else torch.where(act[r], start[r], 0)
        out = kops.chunk_attention_paged(
            qp[r, :, h0 * g:h1 * g].contiguous(), k_pages, v_pages,
            page_start.contiguous(), attended, kp[r, :, h0:h1].contiguous(),
            vp[r, :, h0:h1].contiguous())
        del k_pages, v_pages
        cachelib.paged_block_append_chunk(paged, kp[:, :, :nr], vp[:, :, :nr], start,
                                          chunk_len, active=act, place=place)
        outs.append(_gather_out(out, place, "paged", "k_pages", 2))
    if spec.n_streaming > 0:
        (b0, b1), (h0, h1) = place.bounds[("stream", "k")][:2]
        r = slice(b0, b1)
        ns = h1 - h0
        k_s, v_s = kp[r, :, nr + h0:nr + h1], vp[r, :, nr + h0:nr + h1]
        kr = torch.cat([stream.k, k_s.transpose(1, 2).to(stream.k.dtype)], dim=2)
        vr = torch.cat([stream.v, v_s.transpose(1, 2).to(stream.v.dtype)], dim=2)
        pos_q = paging.chunk_positions(start[r], cch)
        kpos = torch.cat([stream.pos, pos_q[:, None, :].expand(b1 - b0, ns, cch)], dim=2)
        valid_s = paging.chunk_stream_validity(kpos, pos_q, sink=h2.sink, local=h2.local)
        if not spec.idle_rows:
            valid_s &= act[r][:, None, None, None]
        hs = nr * g
        out = kops.chunk_attention(qp[r, :, hs + h0 * g:hs + h1 * g].contiguous(), kr,
                                   vr, valid_s)
        stream = cachelib.stream_cache_append_chunk(
            stream, k_s, v_s, start[r], chunk_len[r], sink=h2.sink, active=act[r])
        outs.append(_gather_out(out, place, "stream", "k", 2))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return _permute_q(out, _inverse_perm(perm), g), paged, stream


def _placed_verify_pages(paged: cachelib.PagedCache, slots, place: cachelib.Placement):
    """The verify's [sink | selected | local] K and V buffers (Bl, Hl, N*P, D)
    of the rank's rows and heads, ``slots`` (Bl, Hl, N) of the full cache.
    Where pages (or token stripes) are cut, each rank fills the tokens it
    owns (``paging.block_tokens``), zeros elsewhere, and one sum over the
    ranks that cut them gives every token from its one owner, exactly; the
    rank's own block is read in place otherwise."""
    cut = place.cut("paged", "k_pages", 2) + place.cut("paged", "k_pages", 3)
    if not cut:
        return kref.gather_pages(paged.k_pages, paged.v_pages, slots)
    (c0, c1), (p0, p1) = place.bounds[("paged", "k_pages")][2:4]
    bl, hl, n = slots.shape
    p, d = place.page, paged.k_pages.shape[-1]
    gk, gv = kref.gather_pages(paged.k_pages, paged.v_pages,
                               paging.block_slots(slots, c0, c1))  # (Bl, Hl, N*Pl, D)
    buf = paged.k_pages.new_zeros((2, bl, hl, n, p, d))
    buf[0, :, :, :, p0:p1] = gk.view(bl, hl, n, p1 - p0, d)
    buf[1, :, :, :, p0:p1] = gv.view(bl, hl, n, p1 - p0, d)
    own = paging.block_tokens(slots, c0, c1, p0, p1, p)[None, ..., None]
    buf = coll.sum_tiles(torch.where(own, buf, 0), place.mesh, cut)
    return buf[0].view(bl, hl, n * p, d), buf[1].view(bl, hl, n * p, d)


def chunk_verify_attention_placed(spec: AttnSpec, q, k_new, v_new,
                                  paged: cachelib.PagedCache,
                                  stream: cachelib.StreamCache, start, active=None,
                                  need_select=None, *, place: cachelib.Placement,
                                  perm=None):
    """``chunk_verify_attention`` on one rank's block of a GSPMD layout. q,
    k_new, v_new (B, k, ...), start, active and need_select are the whole
    batch's; ``paged`` and ``stream`` the rank's blocks. The select is the
    placed decode's (``_placed_select``) at query 0 with context start+1;
    the retrieval heads attend the [sink | selected | local] buffer of the
    rank's rows and heads (``_placed_verify_pages``) followed by the
    chunk's own keys under the causal triangle, the streaming heads the
    rank's ring block followed by the chunk's keys, both through
    ``kops.chunk_attention``. Neither the KV pages nor the ring change.
    Returns (out (B, k, Hq, D), paged, stream), ``out`` the same on every
    rank."""
    h2 = spec.h2
    g = spec.group
    nr = spec.n_retrieval
    qp = _permute_q(q, perm, g)
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    b, kch = q.shape[:2]
    dev = q.device
    act = cachelib._active(active, b, dev)
    need = act if need_select is None else need_select & act
    start = start.reshape(b).to(torch.int32)
    pos_q = paging.chunk_positions(start, kch)
    mesh = place.mesh
    outs = []
    if nr > 0:
        q_r = qp[:, :, : nr * g]
        _placed_select(h2, q_r[:, 0], paged, start + 1, need, place, g)
        (b0, b1), (h0, h1) = place.bounds[("paged", "k_pages")][:2]
        (m0, _), (mh0, _) = place.bounds[("paged", "page_start")][:2]
        (s0, _) = place.bounds[("paged", "sel_idx")][0]
        r = slice(b0, b1)
        slots = _placed_slots(h2, paged.sel_idx[b0 - s0:b1 - s0, h0:h1], start[r] + 1,
                              place)
        gk, gv = _placed_verify_pages(paged, slots, place)
        page_start = _gather_dim(paged.page_start[b0 - m0:b1 - m0, h0 - mh0:h1 - mh0],
                                 mesh, place.axes("paged", "page_start", 2), 2)
        valid_p = paging.verify_token_validity(
            slots, page_start, start[r], pos_q[r], sink=h2.sink, local=h2.local,
            page=h2.page_size, top_k=h2.top_k_pages)
        kr = torch.cat([gk, kp[r, :, h0:h1].transpose(1, 2).to(gk.dtype)], dim=2)
        vr = torch.cat([gv, vp[r, :, h0:h1].transpose(1, 2).to(gv.dtype)], dim=2)
        del gk, gv
        tail = torch.ones(kch, kch, dtype=torch.bool, device=dev).tril()
        valid = torch.cat([valid_p, tail.expand(b1 - b0, h1 - h0, kch, kch)], dim=3)
        out = kops.chunk_attention(q_r[r, :, h0 * g:h1 * g].contiguous(), kr, vr, valid)
        outs.append(_gather_out(out, place, "paged", "k_pages", 2))
    if spec.n_streaming > 0:
        (b0, b1), (h0, h1) = place.bounds[("stream", "k")][:2]
        r = slice(b0, b1)
        k_s, v_s = kp[r, :, nr + h0:nr + h1], vp[r, :, nr + h0:nr + h1]
        kr = torch.cat([stream.k, k_s.transpose(1, 2).to(stream.k.dtype)], dim=2)
        vr = torch.cat([stream.v, v_s.transpose(1, 2).to(stream.v.dtype)], dim=2)
        kpos = torch.cat([stream.pos, pos_q[r][:, None, :].expand(b1 - b0, h1 - h0, kch)],
                         dim=2)
        valid_s = paging.chunk_stream_validity(kpos, pos_q[r], sink=h2.sink,
                                               local=h2.local)
        hs = nr * g
        out = kops.chunk_attention(qp[r, :, hs + h0 * g:hs + h1 * g].contiguous(), kr, vr,
                                   valid_s)
        outs.append(_gather_out(out, place, "stream", "k", 2))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)
    return _permute_q(out, _inverse_perm(perm), g), paged, stream


def chunk_verify_append_placed(spec: AttnSpec, k_new, v_new, paged: cachelib.PagedCache,
                               stream: cachelib.StreamCache, start, accepted,
                               active=None, *, place: cachelib.Placement, perm=None):
    """``chunk_verify_append`` into one rank's blocks: the owner-only chunk
    appends of the accepted prefix (``cache.paged_block_append_chunk``, τ
    min/max and page starts where the metadata's tile keeps them) and the
    ring block's. k_new/v_new (B, k, Hkv, D) and accepted (B,) of the whole
    batch. Returns (paged, stream)."""
    h2 = spec.h2
    nr = spec.n_retrieval
    kp = _permute_kv(k_new, perm)
    vp = _permute_kv(v_new, perm)
    act = cachelib._active(active, k_new.shape[0], k_new.device)
    if nr > 0:
        cachelib.paged_block_append_chunk(paged, kp[:, :, :nr], vp[:, :, :nr], start,
                                          accepted, active=act, place=place)
    if spec.n_streaming > 0:
        (b0, b1), (h0, h1) = place.bounds[("stream", "k")][:2]
        r = slice(b0, b1)
        stream = cachelib.stream_cache_append_chunk(
            stream, kp[r, :, nr + h0:nr + h1], vp[r, :, nr + h0:nr + h1],
            start.reshape(-1)[r], accepted.reshape(-1)[r], sink=h2.sink, active=act[r])
    return paged, stream


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


def full_chunk_attention(spec: AttnSpec, q, k_new, v_new, cache: cachelib.FullCache,
                         start, chunk_len, active=None):
    """A prompt chunk a slot through a layer with a full cache: append, then
    attend the whole cache causally (a window layer: the last
    ``spec.window`` positions). q: (B, C, Hq, D), k_new/v_new (B, C, Hkv,
    D); start/chunk_len/active (B,). Returns (out (B, C, Hq, D), cache)."""
    full = cachelib.full_cache_append_chunk(cache, k_new, v_new, start, chunk_len,
                                            active)
    b, cch = q.shape[:2]
    pos_q = paging.chunk_positions(start, cch)[:, None, :, None]
    key_pos = torch.arange(full.k.shape[2], device=q.device)
    valid = key_pos <= pos_q
    if spec.window > 0:
        valid = valid & (key_pos > pos_q - spec.window)
    valid = valid.expand(b, full.k.shape[1], cch, full.k.shape[2])
    return kops.chunk_attention(q.contiguous(), full.k, full.v, valid.contiguous()), full


def _full_rows_heads(spec: AttnSpec, place: cachelib.Placement):
    """(rows, q heads, kv heads) slices of a full-cache block."""
    (b0, b1), (h0, h1) = place.bounds[("full", "k")][:2]
    g = spec.group
    return slice(b0, b1), slice(h0 * g, h1 * g), slice(h0, h1)


def full_decode_attention_placed(spec: AttnSpec, q, k_new, v_new,
                                 cache: cachelib.FullCache, length, active=None, *,
                                 place: cachelib.Placement):
    """``full_decode_attention`` on one rank's block of a full cache (its
    rows over the batch axes, its kv heads over 'model'): the default body
    on the rank's rows and heads, the output gathered over what cut them.
    A rank holding the whole leaf runs the default's kernels on the same
    inputs and gathers nothing. Returns (out (B, Hq, D), cache)."""
    _require_ragged(length)
    r, hq, hk = _full_rows_heads(spec, place)
    out, cache = full_decode_attention(spec, q[r, hq], k_new[r, hk], v_new[r, hk], cache,
                                       length[r], None if active is None else active[r])
    return _gather_out(out, place, "full", "k", 1), cache


def full_chunk_attention_placed(spec: AttnSpec, q, k_new, v_new,
                                cache: cachelib.FullCache, start, chunk_len,
                                active=None, *, place: cachelib.Placement):
    """``full_chunk_attention`` on one rank's block of a full cache, as
    ``full_decode_attention_placed``. Returns (out (B, C, Hq, D), cache)."""
    r, hq, hk = _full_rows_heads(spec, place)
    out, cache = full_chunk_attention(spec, q[r, :, hq], k_new[r, :, hk], v_new[r, :, hk],
                                      cache, start[r], chunk_len[r],
                                      None if active is None else active[r])
    return _gather_out(out, place, "full", "k", 2), cache

"""Page selection for retrieval heads (counterpart of ``repro/core/paging.py``).

Scores every page from its τ min/max metadata, keeps the top-k, and
builds the [sink pages | selected pages | local pages] buffer with a
validity mask. The page partition, for context length ctx:

  first_local = max(ctx - local, 0) // P
  sink section:     pages [0, n_sink), every in-context token
  local section:    pages [first_local, first_local + n_local), tokens valid
                    iff pos >= max(first_local, n_sink) * P
  selected section: top-k over pages in [n_sink, first_local)

The sections never overlap, and they cover every resident token when
top-k spans all selectable pages. ``ctx`` is a Python int on the lockstep
path and a (B,) tensor on the continuous-batching path, where every slot
has its own context and so its own first local page.

The decode bodies run a select step as one ``kops.page_select`` (the
selectable pages scored, the stable top-k, the importance, the
share-window keep); ``score_pages``, ``select_pages`` and
``accumulate_importance`` are its plain building blocks, as the
reference composes them.

Chunked prefill selects nothing: retrieval heads attend full causal and
streaming heads sink+local, with validity computed from absolute
positions (the chunk helpers at the end).

Under the ``coplace_shmap`` layout the physical page slots are striped
round-robin over S stripes (``interleave_slot``): logical page p lives in
stripe p % S. ``coplace_attended_slots`` builds the attended slot list in
that physical order.

Under the GSPMD layouts ``coplace`` and ``interleave`` a rank owns a
contiguous block of logical pages (and, under ``interleave``'s token
stripes, a contiguous range of each page's offsets): page p belongs to the
rank whose block [first, stop) holds it, and ``block_slots`` turns global
slots into the block's own, -1 where another rank owns the page.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

NEG_INF = -1e30


def page_counts(*, sink: int, local: int, page: int) -> tuple[int, int]:
    """(n_sink_pages, n_local_pages) always attended."""
    n_sink = -(-sink // page) if sink else 0
    n_local = -(-local // page) + 1 if local else 0  # +1 boundary page
    return n_sink, n_local


def first_local_page(ctx, *, local: int, page: int):
    """The first page of the local section: an int for an int ``ctx``, a
    (B,) tensor for a (B,) ``ctx``."""
    if isinstance(ctx, torch.Tensor):
        return torch.clamp(ctx - local, min=0) // page
    return max(ctx - local, 0) // page


def _per_row(x):
    """A per-slot (B,) tensor broadcast over (B, H, N); an int as it is."""
    return x[:, None, None] if isinstance(x, torch.Tensor) else x


def score_pages(q, tau_min, tau_max, page_start, ctx, *, sink: int,
                local: int, page: int):
    """Scores (B, Hkv, C); sink, local and empty pages forced to NEG_INF."""
    scores = kops.page_score(q, tau_min, tau_max)
    selectable = kref.selectable_pages(page_start, ctx, sink=sink, local=local,
                                       page=page)
    return torch.where(selectable, scores, NEG_INF)


def select_pages(scores, top_k_pages: int):
    """Top-k page slots per (B, Hkv): (B, Hkv, K) int32, padded with -1
    when fewer than ``top_k_pages`` pages exist; equal scores keep the lower
    slot first, as ``lax.top_k`` does (``torch.topk`` leaves their order
    open). The order matters: when fewer than k pages are selectable,
    masked pages fill the selection, and one of them can become selectable
    at a later reuse step of the same share window, as the local section
    moves on."""
    return kref.select_top_k(scores, top_k_pages)


def attended_page_slots(sel_idx, ctx, *, sink: int, local: int, page: int):
    """[sink pages | selected pages | local pages] slot indices,
    (B, Hkv, n_sink + K + n_local) int32 (slot == page index == pos // P)."""
    b, h, _ = sel_idx.shape
    n_sink, n_local = page_counts(sink=sink, local=local, page=page)
    dev = sel_idx.device
    first_local = _per_row(first_local_page(ctx, local=local, page=page))
    sink_pages = torch.arange(n_sink, dtype=torch.int32, device=dev)
    local_pages = (first_local + torch.arange(n_local, dtype=torch.int32,
                                              device=dev)).to(torch.int32)
    return torch.cat([sink_pages.expand(b, h, n_sink), sel_idx,
                      local_pages.expand(b, h, n_local)], dim=2)


def interleave_slot(page, capacity: int, n_shards: int):
    """Physical slot of logical page ``page`` (an int or a tensor) when the
    ``capacity`` pages are striped round-robin over ``n_shards`` stripes of
    capacity / n_shards slots each: the owner stripe is page % n_shards.
    The identity for one stripe."""
    if n_shards == 1:
        return page
    return (page % n_shards) * (capacity // n_shards) + page // n_shards


def logical_pages(capacity: int, n_shards: int, device):
    """(capacity,) int64: the logical page each physical slot holds under
    ``interleave_slot``, the inverse permutation."""
    phys = torch.arange(capacity, device=device)
    c_loc = capacity // n_shards
    return (phys % c_loc) * n_shards + phys // c_loc


def coplace_attended_slots(sel_phys, ctx, *, sink: int, local: int, page: int,
                           capacity: int, n_shards: int):
    """``attended_page_slots`` in the striped physical order.

    ``sel_phys`` (B, H, K) holds physical slots already (-1 a sentinel); the
    sink and local sections are logical pages, clipped to the last page
    ``capacity - 1`` and mapped through ``interleave_slot``. Near the
    capacity the clipped local pages repeat the last page, as the
    reference's do. Returns (B, H, n_sink + K + n_local) int32.
    """
    b, h, _ = sel_phys.shape
    n_sink, n_local = page_counts(sink=sink, local=local, page=page)
    dev = sel_phys.device
    first_local = first_local_page(ctx, local=local, page=page)
    fl = first_local.reshape(-1, 1) if isinstance(first_local, torch.Tensor) \
        else first_local
    fixed = torch.cat([
        torch.arange(n_sink, device=dev).expand(b, n_sink),
        (fl + torch.arange(n_local, device=dev)).expand(b, n_local)], dim=1)
    fixed = interleave_slot(fixed.clamp(0, capacity - 1), capacity,
                            n_shards).to(torch.int32)[:, None, :].expand(
        b, h, n_sink + n_local)
    return torch.cat([fixed[:, :, :n_sink], sel_phys.to(torch.int32),
                      fixed[:, :, n_sink:]], dim=2)


def block_slots(slots, first: int, stop: int):
    """Page slots local to a block of pages [first, stop) of the full cache
    (a rank's block under a GSPMD layout that shards pages): slot - first
    where the rank owns the page, -1 (a sentinel) elsewhere."""
    own = (slots >= first) & (slots < stop)
    return torch.where(own, slots - first, -1).to(torch.int32)


def block_tokens(slots, first: int, stop: int, tok_first: int, tok_stop: int,
                 page: int):
    """(B, H, N, P) bool: the tokens of a gathered [sink | selected | local]
    buffer (``slots`` (B, H, N) of the full cache) that a rank's block holds,
    its pages [first, stop) and, under token stripes, the offsets [tok_first,
    tok_stop) of each page. Every token of the buffer has exactly one owner
    among the ranks that cut the pages."""
    own = (slots >= first) & (slots < stop)
    off = torch.arange(page, device=slots.device)
    return own[..., None] & ((off >= tok_first) & (off < tok_stop))


def token_validity(slots, page_start, ctx, *, sink: int, local: int,
                   page: int, top_k: int):
    """Validity mask (B, H, N*P) of the gathered token buffer, enforcing
    the section partition of the module docstring. A sentinel slot (-1)
    and a local page past the end of the cache (at a context within one
    local window of the capacity) are invalid: such a page holds no
    position below the capacity, so clamping and masking it attends
    exactly the in-context tokens."""
    b, h, n = slots.shape
    n_sink, n_local = page_counts(sink=sink, local=local, page=page)
    dev = slots.device
    c = page_start.shape[2]
    sentinel = ((slots < 0) | (slots >= c))[..., None]
    start = torch.gather(page_start, 2, slots.clamp(0, c - 1).long())
    pos = start[..., None] + torch.arange(page, dtype=torch.int32, device=dev)
    nonempty = (start >= 0)[..., None]
    in_ctx = pos < _per_row(ctx)[..., None] if isinstance(ctx, torch.Tensor) \
        else pos < ctx
    sec = torch.cat([
        torch.zeros(n_sink, dtype=torch.int32, device=dev),
        torch.ones(top_k, dtype=torch.int32, device=dev),
        torch.full((n_local,), 2, dtype=torch.int32, device=dev),
    ])[None, None, :, None]
    first_local = _per_row(first_local_page(ctx, local=local, page=page))
    low = (torch.clamp(first_local, min=n_sink)[..., None]
           if isinstance(first_local, torch.Tensor) else max(first_local, n_sink))
    pidx = torch.div(start, page, rounding_mode="floor")
    ok_local = (pos >= low * page) & (pidx >= first_local)[..., None]
    ok_sel = ((pidx >= n_sink) & (pidx < first_local))[..., None]
    ok = torch.where(sec == 0, True, torch.where(sec == 2, ok_local, ok_sel))
    return (nonempty & in_ctx & ok & ~sentinel).reshape(b, h, n * page)


def slots_of_positions(page_start, positions):
    """The eviction pool's slot lookup: for each target page start, the
    slot that holds it (the lowest if several do), or -1. page_start:
    (B, H, C); positions: (N,) or (B, H, N) -> (B, H, N) int32."""
    if positions.dim() == 1:
        positions = positions.expand(*page_start.shape[:2], positions.shape[0])
    eq = page_start[:, :, :, None] == positions[:, :, None, :]
    slot = eq.to(torch.int8).argmax(dim=2)
    return torch.where(eq.any(dim=2), slot, -1).to(torch.int32)


def evict_lowest(importance, page_start):
    """(B, H) int32: the slot of each row's live page (page_start >= 0) of
    lowest importance, the lower slot among equals (slot 0 if none is
    live): the page the eviction pool overwrites next."""
    masked = torch.where(page_start >= 0, importance, float("inf"))
    return masked.argmin(dim=-1).to(torch.int32)


def accumulate_importance(importance, scores):
    """Add this step's scores; masked (NEG_INF) pages contribute 0."""
    return importance + torch.where(scores > NEG_INF / 2, scores, 0.0)


# ---------------------------------------------------------------------------
# Chunked prefill: validity from absolute positions
# ---------------------------------------------------------------------------


def chunk_positions(start, chunk: int):
    """Absolute positions (B, C) of a left-aligned chunk starting at
    ``start`` (B,). Rows are valid only below the caller's chunk_len."""
    return start.reshape(-1, 1) + torch.arange(chunk, dtype=start.dtype,
                                               device=start.device)


def paged_key_positions(page_start, page: int):
    """(key_pos, key_ok) (B, H, C*P) of the flattened page buffer, from the
    absolute first-token position of each page (-1 empty)."""
    b, h, c = page_start.shape
    pos = page_start[..., None] + torch.arange(page, dtype=page_start.dtype,
                                               device=page_start.device)
    ok = (page_start >= 0)[..., None].expand(b, h, c, page)
    return pos.reshape(b, h, c * page), ok.reshape(b, h, c * page)


def chunk_causal_validity(key_pos, key_ok, pos_q):
    """(B, H, Cq, T): a key is attended iff it exists and its position is
    at most the query's. key_pos/key_ok: (B, H, T); pos_q: (B, Cq)."""
    return key_ok[:, :, None, :] & (key_pos[:, :, None, :] <= pos_q[:, None, :, None])


def chunk_stream_validity(key_pos, pos_q, *, sink: int, local: int):
    """Sink+local mask (B, H, Cq, T), the streaming decode mask per query:
    (pos < sink) | (pos > q - local), causal, -1 = empty slot."""
    kp = key_pos[:, :, None, :]
    pq = pos_q[:, None, :, None]
    return (kp >= 0) & (kp <= pq) & ((kp < sink) | (kp > pq - local))


# ---------------------------------------------------------------------------
# Speculative verify: k decode steps as one chunk over the PRE-append cache
#
# The verify chunk holds k tokens at positions start .. start+k-1; query j
# attends what the sequential engine's step j would. Keys at positions >=
# start are not in the cache yet (attend-before-append): they come as the
# chunk's own keys under a causal triangle, so the pages supply positions
# < start only and the in-context bound is the cache's, one for every
# query. The section partition is per query: first_local(start+j+1) grows
# with j, so a page local for query 0 can be selectable-but-unselected
# (dropped, as the sequential reuse step drops it) for query k-1. The
# gathered buffer is anchored at first_local(start+1): every query's local
# low edge is at or above it, and the highest live page (start-1)//P lies
# within n_local pages of it.
# ---------------------------------------------------------------------------


def verify_attended_slots(sel_idx, ctx, *, sink: int, local: int, page: int,
                          capacity: int, n_shards: int = 1):
    """[sink | selected | local] slots of the verify gather, anchored at
    ``ctx`` (B,) = start + 1, the context of the chunk's first query: the
    decode step's slot list of each layout (``attended_page_slots``, or
    ``coplace_attended_slots`` in the striped order for ``n_shards`` > 1,
    its fixed sections clipped to the last of the ``capacity`` pages).
    Returns (B, Hkv, n_sink + K + n_local) int32."""
    if n_shards == 1:
        return attended_page_slots(sel_idx, ctx, sink=sink, local=local, page=page)
    return coplace_attended_slots(sel_idx, ctx, sink=sink, local=local, page=page,
                                  capacity=capacity, n_shards=n_shards)


def verify_token_validity(slots, page_start, cache_ctx, pos_q, *, sink: int,
                          local: int, page: int, top_k: int):
    """Per-query validity (B, H, Cq, N*P) of the gathered verify buffer: the
    section rules of ``token_validity`` with two changes. The in-context
    bound is the pre-append cache length ``cache_ctx`` (B,), one for every
    query, since the chunk's keys come apart; and the sink / selected /
    local partition is taken at each query's own context ``pos_q + 1``
    (pos_q (B, Cq) absolute positions), so a page changes section along the
    chunk as it does along k sequential decode steps. A sentinel slot (-1)
    and a slot past the cache's last page are invalid."""
    b, h, n = slots.shape
    cq = pos_q.shape[1]
    n_sink, n_local = page_counts(sink=sink, local=local, page=page)
    dev = slots.device
    c = page_start.shape[2]
    sentinel = ((slots < 0) | (slots >= c))[:, :, None, :, None]
    start = torch.gather(page_start, 2, slots.clamp(0, c - 1).long())
    pos = (start[..., None] + torch.arange(page, dtype=torch.int32,
                                           device=dev))[:, :, None]
    nonempty = (start >= 0)[:, :, None, :, None]
    in_ctx = pos < cache_ctx.reshape(b, 1, 1, 1, 1)
    sec = torch.cat([
        torch.zeros(n_sink, dtype=torch.int32, device=dev),
        torch.ones(top_k, dtype=torch.int32, device=dev),
        torch.full((n_local,), 2, dtype=torch.int32, device=dev),
    ])[None, None, None, :, None]
    first_local = first_local_page(pos_q + 1, local=local,
                                   page=page)[:, None, :, None, None]
    pidx = torch.div(start, page, rounding_mode="floor")[:, :, None, :, None]
    ok_local = ((pos >= torch.clamp(first_local, min=n_sink) * page)
                & (pidx >= first_local))
    ok_sel = (pidx >= n_sink) & (pidx < first_local)
    ok = torch.where(sec == 0, True, torch.where(sec == 2, ok_local, ok_sel))
    return (nonempty & in_ctx & ok & ~sentinel).reshape(b, h, cq, n * page)

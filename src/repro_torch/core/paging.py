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

Chunked prefill selects nothing: retrieval heads attend full causal and
streaming heads sink+local, with validity computed from absolute
positions (the chunk helpers at the end).

Under the ``coplace_shmap`` layout the physical page slots are striped
round-robin over S stripes (``interleave_slot``): logical page p lives in
stripe p % S. ``coplace_attended_slots`` builds the attended slot list in
that physical order.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops

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
    n_sink, _ = page_counts(sink=sink, local=local, page=page)
    first_local = _per_row(first_local_page(ctx, local=local, page=page))
    pidx = torch.where(page_start >= 0, page_start // page, -1)
    selectable = (page_start >= 0) & (pidx >= n_sink) & (pidx < first_local)
    return torch.where(selectable, scores, NEG_INF)


def top_k(x, k: int):
    """(values, indices) of the k largest entries along the last dim; equal
    values keep the lower index first, as ``lax.top_k`` does
    (``torch.topk`` leaves their order open)."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]
    return x.gather(-1, order), order


def pad_selection(idx, k: int):
    """(..., n) page slots -> (..., k) int32, padded with -1 (n <= k)."""
    idx = idx.to(torch.int32)
    if idx.shape[-1] < k:
        idx = torch.cat([idx, idx.new_full(idx.shape[:-1] + (k - idx.shape[-1],),
                                           -1)], dim=-1)
    return idx


def select_pages(scores, top_k_pages: int):
    """Top-k page slots per (B, Hkv): (B, Hkv, K) int32, padded with -1
    when fewer than ``top_k_pages`` pages exist, in ``top_k``'s order. The
    order matters: when fewer than k pages are selectable, masked pages
    fill the selection, and one of them can become selectable at a later
    reuse step of the same share window, as the local section moves on."""
    _, idx = top_k(scores, min(top_k_pages, scores.shape[-1]))
    return pad_selection(idx, top_k_pages)


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


def gather_pages(k_pages, v_pages, slots):
    """k/v_pages: (B, H, C, P, D); slots: (B, H, N) -> (B, H, N*P, D) each.
    Slots are clamped into [0, C): a sentinel, or a local page past the
    end, reads some page, and ``token_validity`` masks it."""
    b, h, c, p, d = k_pages.shape
    n = slots.shape[2]
    sc = slots.clamp(0, c - 1).long()
    bi = torch.arange(b, device=slots.device)[:, None, None]
    hi = torch.arange(h, device=slots.device)[None, :, None]
    return (k_pages[bi, hi, sc].reshape(b, h, n * p, d),
            v_pages[bi, hi, sc].reshape(b, h, n * p, d))


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

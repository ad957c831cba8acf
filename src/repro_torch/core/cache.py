"""KV-cache structures for H²EAL serving (counterpart of ``repro/core/cache.py``).

  FullCache    dense (B, H, S, D) baseline, used when H²EAL is disabled.
  PagedCache   retrieval heads: paged KV + per-page key min/max (τ)
               metadata + accumulated importance + page_start table.
  StreamCache  streaming heads: sink + local ring buffer.

The single-token appends take ``length`` as a Python int (the lockstep
path: every row writes at one position) or as a (B,) tensor (the
continuous-batching path: each slot writes at its own position, and rows
whose ``active`` flag is False are written back unchanged). The chunk
appends feed a left-aligned chunk of prompt tokens per slot.

Unlike the JAX package, whose arrays are immutable, every append writes
into the cache tensors IN PLACE and returns the same cache object: one
decode step then moves a token's worth of bytes, not a copy of the cache.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.paging import interleave_slot, logical_pages


@dataclasses.dataclass
class FullCache:
    k: torch.Tensor  # (B, Hkv, S, D)
    v: torch.Tensor  # (B, Hkv, S, D)


@dataclasses.dataclass
class PagedCache:
    k_pages: torch.Tensor     # (B, Hr, C, P, D)
    v_pages: torch.Tensor     # (B, Hr, C, P, D)
    tau_min: torch.Tensor     # (B, Hr, C, D) f32, elementwise min of the page's keys
    tau_max: torch.Tensor     # (B, Hr, C, D) f32
    importance: torch.Tensor  # (B, Hr, C) f32 accumulated relevance
    page_start: torch.Tensor  # (B, Hr, C) int32 position of the first token; -1 empty
    sel_idx: torch.Tensor     # (B, Hr, K) int32 cached top-k selection


@dataclasses.dataclass
class StreamCache:
    k: torch.Tensor    # (B, Hs, W, D), W = sink + local_cap; the local part is a ring
    v: torch.Tensor    # (B, Hs, W, D)
    pos: torch.Tensor  # (B, Hs, W) int32 absolute position in each slot; -1 empty


def make_stream_cache(b, h_s, sink, local_cap, d, *, dtype, device):
    w = sink + local_cap
    z = lambda: torch.zeros((b, h_s, w, d), dtype=dtype, device=device)
    return StreamCache(k=z(), v=z(), pos=torch.full((b, h_s, w), -1,
                                                    dtype=torch.int32,
                                                    device=device))


def empty_fill_value(field: str):
    """The empty-cache value of a cache field, the one a fresh cache holds:
    tau_min +inf, tau_max -inf, page_start and the ring's pos -1, every
    other field 0. The serving engine writes these into a slot's rows when
    it admits a request chunk by chunk, so that no key of a previous
    occupant passes a validity mask and the chunk appends' running τ
    min/max merge starts from the identity."""
    return {"tau_min": float("inf"), "tau_max": float("-inf"),
            "page_start": -1, "pos": -1}.get(field, 0)


def make_full_cache(b, h_kv, capacity, d, *, dtype, device):
    z = lambda: torch.zeros((b, h_kv, capacity, d), dtype=dtype, device=device)
    return FullCache(k=z(), v=z())


def make_paged_cache(b, h_r, num_pages, page, d, top_k, *, dtype, device):
    """An empty paged cache (every field at ``empty_fill_value``)."""
    zp = lambda: torch.zeros((b, h_r, num_pages, page, d), dtype=dtype,
                             device=device)
    full = lambda s, v, dt: torch.full(s, v, dtype=dt, device=device)
    f32, i32 = torch.float32, torch.int32
    return PagedCache(k_pages=zp(), v_pages=zp(),
                      tau_min=full((b, h_r, num_pages, d), float("inf"), f32),
                      tau_max=full((b, h_r, num_pages, d), float("-inf"), f32),
                      importance=full((b, h_r, num_pages), 0.0, f32),
                      page_start=full((b, h_r, num_pages), -1, i32),
                      sel_idx=full((b, h_r, top_k), 0, i32))


# ---------------------------------------------------------------------------
# Appends: one token for all heads of one layer, at position ``length``
# ---------------------------------------------------------------------------


def _active(active, b: int, device):
    return (torch.ones(b, dtype=torch.bool, device=device) if active is None
            else active.reshape(b))


def _rows(length, active, b: int, device):
    """(length (B,) int64, active (B,) bool) of the ragged path."""
    return length.reshape(-1).expand(b).long(), _active(active, b, device)


def full_cache_append(cache: FullCache, k_new, v_new, length,
                      active=None) -> FullCache:
    """k_new/v_new: (B, Hkv, D) written at slot ``length`` (in place)."""
    if not isinstance(length, torch.Tensor):
        cache.k[:, :, length] = k_new.to(cache.k.dtype)
        cache.v[:, :, length] = v_new.to(cache.v.dtype)
        return cache
    b, _, s, _ = cache.k.shape
    lb, act = _rows(length, active, b, cache.k.device)
    bi = torch.arange(b, device=lb.device)
    sl = lb.clamp(0, s - 1)
    a3 = act[:, None, None]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        buf[bi, :, sl] = torch.where(a3, new.to(buf.dtype), buf[bi, :, sl])
    return cache


def stream_cache_append(cache: StreamCache, k_new, v_new, length, *,
                        sink: int, active=None) -> StreamCache:
    """Ring append (in place): positions below ``sink`` keep their own slot,
    later ones cycle over the local part."""
    local_cap = cache.k.shape[2] - sink
    if not isinstance(length, torch.Tensor):
        slot = length if length < sink else sink + (length - sink) % local_cap
        cache.k[:, :, slot] = k_new.to(cache.k.dtype)
        cache.v[:, :, slot] = v_new.to(cache.v.dtype)
        cache.pos[:, :, slot] = length
        return cache
    b = cache.k.shape[0]
    lb, act = _rows(length, active, b, cache.k.device)
    slot = torch.where(lb < sink, lb, sink + (lb - sink) % local_cap)
    bi = torch.arange(b, device=lb.device)
    a3 = act[:, None, None]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        buf[bi, :, slot] = torch.where(a3, new.to(buf.dtype), buf[bi, :, slot])
    cache.pos[bi, :, slot] = torch.where(act[:, None], lb[:, None].int(),
                                         cache.pos[bi, :, slot])
    return cache


def paged_cache_append(cache: PagedCache, k_new, v_new, length, active=None,
                       *, phys_shards: int = 1) -> PagedCache:
    """Append one token at position ``length`` (logical page length // P),
    in place, updating the page's running τ min/max and its start.

    ``phys_shards`` > 1 is the ``coplace_shmap`` owner-stripe append: the
    token goes to the page's physical slot ``paging.interleave_slot``, which
    is what the reference's per-shard append writes on the one shard owning
    it (the others write nothing); the page start stays the logical one."""
    b, _, c, p = cache.k_pages.shape[:4]
    if not isinstance(length, torch.Tensor):
        page, off = divmod(length, p)
        if page >= c:
            raise ValueError(f"position {length} lies past the cache's {c} pages")
        slot = interleave_slot(page, c, phys_shards)
        cache.k_pages[:, :, slot, off] = k_new.to(cache.k_pages.dtype)
        cache.v_pages[:, :, slot, off] = v_new.to(cache.v_pages.dtype)
        kf = k_new.float()
        cache.tau_min[:, :, slot] = torch.minimum(cache.tau_min[:, :, slot], kf)
        cache.tau_max[:, :, slot] = torch.maximum(cache.tau_max[:, :, slot], kf)
        cache.page_start[:, :, slot] = page * p
        return cache
    lb, act = _rows(length, active, b, cache.k_pages.device)
    page = (lb // p).clamp(0, c - 1)
    slot = interleave_slot(page, c, phys_shards)
    off = lb % p
    bi = torch.arange(b, device=lb.device)
    a3 = act[:, None, None]
    for buf, new in ((cache.k_pages, k_new), (cache.v_pages, v_new)):
        buf[bi, :, slot, off] = torch.where(a3, new.to(buf.dtype),
                                            buf[bi, :, slot, off])
    kf = k_new.float()
    old_min, old_max = cache.tau_min[bi, :, slot], cache.tau_max[bi, :, slot]
    cache.tau_min[bi, :, slot] = torch.where(a3, torch.minimum(old_min, kf), old_min)
    cache.tau_max[bi, :, slot] = torch.where(a3, torch.maximum(old_max, kf), old_max)
    cache.page_start[bi, :, slot] = torch.where(
        act[:, None], (page * p)[:, None].int(), cache.page_start[bi, :, slot])
    return cache


# ---------------------------------------------------------------------------
# Chunk appends (chunked prefill): a left-aligned chunk per slot. Slot b
# appends its first chunk_len[b] tokens at positions start[b] ..
# start[b] + chunk_len[b] - 1; the rest of the chunk, and every slot whose
# ``active`` flag is False, append nothing.
#
# The writes are in place. Every chunk token of a row goes to its own
# location: position start + j taken modulo the buffer's length (valid
# positions lie inside the buffer, so they keep their true location, and a
# chunk no longer than the buffer never maps two tokens to one location).
# A masked token writes back the value it finds, so no masked write can
# race a valid one, which is what the JAX package's transient overflow
# page achieves there.
# ---------------------------------------------------------------------------


def _chunk_rows(start, chunk_len, active, b: int, cch: int, device):
    """(positions (B, C) int64, token valid (B, C) bool)."""
    j = torch.arange(cch, device=device)
    pos = start.reshape(b, 1).long() + j
    valid = (j < chunk_len.reshape(b, 1)) & _active(active, b, device)[:, None]
    return pos, valid


def _put_tokens(buf, loc, valid, new):
    """buf: (B, H, N, D); write new (B, C, H, D) at buf[b, :, loc[b, j]]
    for the valid tokens, in place."""
    bi = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[bi, :, loc] = torch.where(valid[:, :, None, None], new.to(buf.dtype),
                                  buf[bi, :, loc])


def paged_cache_append_chunk(cache: PagedCache, k_new, v_new, start,
                             chunk_len, *, active=None,
                             phys_shards: int = 1) -> PagedCache:
    """k_new/v_new: (B, C, Hr, D). Page τ min/max merge by scatter-min/max
    (a masked token adds the identity ±inf), exact for chunks that open,
    fill or straddle pages, PROVIDED the touched pages start from the
    empty values (the engine resets a slot's rows at admission).
    ``phys_shards`` > 1 writes each logical page into its striped physical
    slot (``paging.interleave_slot``, the ``coplace_shmap`` order); the page
    starts stay logical positions."""
    b, cch, h, d = k_new.shape
    cap, p = cache.k_pages.shape[2:4]
    pos, valid = _chunk_rows(start, chunk_len, active, b, cch, k_new.device)
    # (pos mod cap*P) -> (page mod cap, offset) -> striped slot is one-to-one
    slot = interleave_slot((pos // p) % cap, cap, phys_shards)
    loc = slot * p + pos % p
    _put_tokens(cache.k_pages.view(b, h, cap * p, d), loc, valid, k_new)
    _put_tokens(cache.v_pages.view(b, h, cap * p, d), loc, valid, v_new)
    idx = slot[:, None, :, None].expand(b, h, cch, d)
    kf = k_new.float().transpose(1, 2)                     # (B, H, C, D)
    vmask = valid[:, None, :, None]
    cache.tau_min.scatter_reduce_(2, idx, torch.where(vmask, kf, float("inf")),
                                  "amin")
    cache.tau_max.scatter_reduce_(2, idx, torch.where(vmask, kf, float("-inf")),
                                  "amax")
    # a page is opened iff a valid token falls in it: logical pages
    # start // P .. (start + chunk_len - 1) // P of an active slot with
    # chunk_len > 0; each physical slot holds logical page pg
    last = pos.gather(1, (chunk_len.reshape(b, 1).long() - 1).clamp(min=0))
    n_valid = valid.any(dim=1, keepdim=True)
    pg = logical_pages(cap, phys_shards, k_new.device)
    opened = n_valid & (pg >= pos[:, :1] // p) & (pg <= last // p)   # (B, cap)
    cache.page_start.copy_(torch.where(opened[:, None, :], (pg * p).int(),
                                       cache.page_start))
    return cache


def stream_cache_append_chunk(cache: StreamCache, k_new, v_new, start,
                              chunk_len, *, sink: int,
                              active=None) -> StreamCache:
    """k_new/v_new: (B, C, Hs, D). Equivalent to appending the chunk one
    token at a time with ``stream_cache_append``, in closed form: each ring
    slot keeps the LAST chunk position that maps to it, so a chunk longer
    than the ring is handled exactly."""
    b, cch, h, d = k_new.shape
    w = cache.k.shape[2]
    local_cap = w - sink
    dev = k_new.device
    start = start.reshape(b, 1).long()
    act = _active(active, b, dev)
    e = start + chunk_len.reshape(b, 1).long() - 1          # last position
    wi = torch.arange(w, device=dev)[None, :]
    p_ring = e - (e - sink - (wi - sink)) % local_cap
    p_tgt = torch.where(wi < sink, wi, p_ring)              # (B, W)
    written = (act[:, None] & (p_tgt >= start) & (p_tgt <= e)
               & ((wi < sink) | (p_tgt >= sink)))
    jidx = (p_tgt - start).clamp(0, cch - 1)
    gidx = jidx[:, None, :, None].expand(b, h, w, d)
    wr = written[:, None, :, None]
    for buf, new in ((cache.k, k_new), (cache.v, v_new)):
        took = new.transpose(1, 2).gather(2, gidx).to(buf.dtype)
        buf.copy_(torch.where(wr, took, buf))
    cache.pos.copy_(torch.where(written[:, None, :], p_tgt[:, None, :].int(),
                                cache.pos))
    return cache


def full_cache_append_chunk(cache: FullCache, k_new, v_new, start, chunk_len,
                            active=None) -> FullCache:
    """k_new/v_new: (B, C, Hkv, D) appended at positions start ..
    start + chunk_len - 1 per slot (dense baseline cache)."""
    b, cch = k_new.shape[:2]
    pos, valid = _chunk_rows(start, chunk_len, active, b, cch, k_new.device)
    loc = pos % cache.k.shape[2]
    _put_tokens(cache.k, loc, valid, k_new)
    _put_tokens(cache.v, loc, valid, v_new)
    return cache


# ---------------------------------------------------------------------------
# Prefill constructors (build caches from full-sequence K/V)
# ---------------------------------------------------------------------------


def paged_cache_from_prefill(k, v, num_pages: int, page: int, top_k: int) -> PagedCache:
    """k/v: (B, S, Hr, D) with S % page == 0 -> PagedCache with S // page
    pages filled."""
    b, s, h, d = k.shape
    n_filled = s // page
    kp = k.permute(0, 2, 1, 3).reshape(b, h, n_filled, page, d)
    vp = v.permute(0, 2, 1, 3).reshape(b, h, n_filled, page, d)
    dev = k.device
    k_pages = torch.zeros((b, h, num_pages, page, d), dtype=k.dtype, device=dev)
    v_pages = torch.zeros_like(k_pages)
    k_pages[:, :, :n_filled] = kp
    v_pages[:, :, :n_filled] = vp
    kf = kp.float()
    tau_min = torch.full((b, h, num_pages, d), float("inf"), device=dev)
    tau_max = torch.full((b, h, num_pages, d), float("-inf"), device=dev)
    tau_min[:, :, :n_filled] = kf.amin(dim=3)
    tau_max[:, :, :n_filled] = kf.amax(dim=3)
    idx = torch.arange(num_pages, dtype=torch.int32, device=dev)
    start = torch.where(idx < n_filled, idx * page, -1).to(torch.int32)
    return PagedCache(
        k_pages=k_pages, v_pages=v_pages, tau_min=tau_min, tau_max=tau_max,
        importance=torch.zeros((b, h, num_pages), dtype=torch.float32, device=dev),
        page_start=start.expand(b, h, num_pages).contiguous(),
        sel_idx=torch.zeros((b, h, top_k), dtype=torch.int32, device=dev))


def stream_cache_from_prefill(k, v, *, sink: int, local_cap: int,
                              length: int) -> StreamCache:
    """k/v: (B, S, Hs, D); keep the sink and the last min(local_cap,
    S - sink) tokens, each in the slot a ring append would have used."""
    b, s, h, d = k.shape
    cache = make_stream_cache(b, h, sink, local_cap, d, dtype=k.dtype,
                              device=k.device)
    pos = torch.arange(s, device=k.device)
    keep = (pos < sink) | (pos >= max(sink, length - local_cap))
    pos = pos[keep]
    slot = torch.where(pos < sink, pos, sink + (pos - sink) % local_cap)
    cache.k[:, :, slot] = k.permute(0, 2, 1, 3)[:, :, pos]
    cache.v[:, :, slot] = v.permute(0, 2, 1, 3)[:, :, pos]
    cache.pos[:, :, slot] = pos.to(torch.int32)
    return cache
